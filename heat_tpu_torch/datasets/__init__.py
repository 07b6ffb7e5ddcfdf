"""Bundled demo datasets (counterpart of heat_tpu/datasets).

Fisher's iris and the diabetes regression set, as HDF5 and CSV files for
the examples and the io tests; the port ships its own copies of the JAX
package's files.  Use :func:`path` to locate a bundled file:

    import heat_tpu_torch as ht
    X = ht.load_csv(ht.datasets.path("iris.csv"), sep=";", split=0)
"""

import os

__all__ = ["path"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def path(name: str) -> str:
    """Absolute path of a bundled dataset file (e.g. ``"iris.h5"``)."""
    p = os.path.join(_HERE, name)
    if not os.path.isfile(p):
        available = sorted(f for f in os.listdir(_HERE) if not f.endswith(".py"))
        raise FileNotFoundError(f"no bundled dataset {name!r}; available: {available}")
    return p
