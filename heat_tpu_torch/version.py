"""Version information for heat_tpu_torch: the JAX package's version
(heat_tpu/version.py), kept here as the port's own copy."""

major: int = 0
"""Major version number."""
minor: int = 2
"""Minor version number."""
micro: int = 0
"""Micro (patch) version number."""
extension: str = "dev"
"""Pre-release qualifier."""

if not extension:
    __version__ = f"{major}.{minor}.{micro}"
else:
    __version__ = f"{major}.{minor}.{micro}-{extension}"
