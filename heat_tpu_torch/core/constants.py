"""Mathematical constants (counterpart of heat_tpu/core/constants.py)."""

import math

__all__ = ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi"]

e = math.e
Euler = math.e
inf = math.inf
Inf = math.inf
Infty = math.inf
Infinity = math.inf
nan = math.nan
NaN = math.nan
pi = math.pi
