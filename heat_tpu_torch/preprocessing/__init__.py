"""Preprocessing transforms (counterpart of heat_tpu/preprocessing)."""

from .preprocessing import MaxAbsScaler, MinMaxScaler, Normalizer, RobustScaler, StandardScaler

__all__ = ["StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"]
