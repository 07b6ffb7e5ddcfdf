"""FFT (counterpart of heat_tpu/fft): the 22 transforms and helpers of
numpy.fft on split DNDarrays, on the card through the hand-written kernels
K3-K6."""

from .fft import *
