"""Devices (counterpart of heat_tpu/core/devices.py).

An array lives on the host (``cpu``) or on this rank's CUDA card (``gpu``).
The default is the card: every entry point runs there unless the caller asks
for the CPU, per call with ``device="cpu"`` or for the process with
:func:`use_device`.  Asking for the card where there is none raises; nothing
falls back to the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "sanitize_device", "use_device"]


class Device:
    """The platform an array lives on: ``"cpu"`` or ``"gpu"``."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.__device_type = str(device_type)
        self.__device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        return self.__device_id

    @property
    def torch_device(self) -> torch.device:
        """The torch device this stands for; raises where the card is missing."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "heat_tpu_torch runs on the CUDA card by default and finds none; "
                "ask for the CPU with device='cpu' or heat_tpu_torch.use_device('cpu')"
            )
        return torch.device("cuda", torch.cuda.current_device())

    def __repr__(self) -> str:
        return f"device({str(self)!r})"

    def __str__(self) -> str:
        return f"{self.device_type}:{self.device_id}"

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type and self.device_id == other.device_id
        if isinstance(other, str):
            return str(self) == other or self.device_type == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(str(self))


cpu = Device("cpu")
gpu = Device("gpu")

_NAMES = {"cpu": cpu, "gpu": gpu, "cuda": gpu}
__default_device = gpu


def get_device() -> Device:
    """The current default device."""
    return __default_device


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Validate ``device`` or return the default."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        device = device.type
    name = str(device).split(":")[0].strip().lower()
    if name in _NAMES:
        return _NAMES[name]
    raise ValueError(f"Unknown device, must be one of {sorted(_NAMES)}, got {device!r}")


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the default device of this process."""
    global __default_device
    __default_device = sanitize_device(device)
