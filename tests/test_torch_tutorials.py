"""The reference's tutorials 1-6 (tutorials/local) run through the port.

Each notebook's code cells run with ``import heat_tpu as ht`` read as
``import heat_tpu_torch as ht`` (on the CPU), and every line they print is
compared with what the same cells print through heat_tpu.  The reference
runs on a one-device Communication, so that the lines that print the
world's layout ("mesh size", the padded buffer, ``lshape_map``) are of the
port's world of one.  Two things are read alike before comparing: the
package name (``heat_tpu_torch`` as ``heat_tpu``, e.g. in a printed type)
and a torch shape (``torch.Size([13])`` as numpy's ``(13,)``), since the
port's local buffers are torch tensors where the reference's are jax
arrays.

Tutorial 5 prints the residuals of factorizations, rounding noise that two
correct LAPACK builds (MKL under torch, XLA's own under JAX) do not share:
its lines are held to the same text with every number within rtol 1e-5 and
atol 1e-4, the bound of the reference's own QR test
(tests/test_linalg.py:46), instead of the same digits.  Tutorial 4 prints
``float(ht.mean(xs))`` and ``float(ht.std(xs))`` of standardized data, sums
whose rounding follows the order of the additions: held to the same text
and atol 1e-6 (its mean is of order 1e-9, its std 1).  Tutorial 6 prints
KMeans' centres, whose per-cluster sums round in each package's order of
additions (one float32 ulp apart): held to the same text and atol 5e-5,
the bound the port's KMeans parity holds centres to; its labels, shapes
and iteration count are integers, equal.

Tutorial 3's cell that prints ``a.larray_padded.sharding`` is skipped: a
``jax.sharding`` object has no counterpart in the port (a rank's buffer is
a plain tensor; its layout is ``lshape_map``, which the tutorial prints)."""

import contextlib
import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht

TUTORIALS = Path(__file__).resolve().parents[1] / "tutorials" / "local"
NOTEBOOKS = ["1_intro.ipynb", "2_basics.ipynb", "3_internals.ipynb", "4_loading_preprocessing.ipynb",
             "5_matrix_factorizations.ipynb", "6_clustering.ipynb"]
# notebooks whose numbers are compared within (rtol, atol), not digit by digit
NUMERIC = {"4_loading_preprocessing.ipynb": (1e-6, 1e-6), "5_matrix_factorizations.ipynb": (1e-5, 1e-4),
           "6_clustering.ipynb": (0.0, 5e-5)}
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?inf|nan")
# cells with no counterpart in the port, by the text they print
SKIP = {"print(a.larray_padded.sharding)": "a jax.sharding object has no counterpart in the port"}


def _cells(name):
    nb = json.loads((TUTORIALS / name).read_text())
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def _run(cells, port: bool) -> list:
    """Each cell's printed lines, the cells run in one namespace."""
    ns, out = {}, []
    for src in cells:
        if any(s in src for s in SKIP):
            out.append(None)
            continue
        if port:
            src = src.replace("import heat_tpu as ht", "import heat_tpu_torch as ht")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(compile(src, "<cell>", "exec"), ns)
        out.append(buf.getvalue())
    return out


def _read(text: str) -> str:
    text = text.replace("heat_tpu_torch", "heat_tpu")
    return re.sub(r"torch\.Size\(\[([^\]]*)\]\)",
                  lambda m: "(" + (m.group(1) + "," if "," not in m.group(1) and m.group(1) else m.group(1)) + ")",
                  text)


def _same_numbers(got: str, want: str, rtol: float, atol: float, where: str) -> None:
    """The same text with every number masked (and runs of spaces read as
    one: numpy pads an array's entries to its widest), and each number
    within (rtol, atol) of the reference's."""
    def masked(text):
        return [re.sub(r" +", " ", _NUMBER.sub("#", line)) for line in text.splitlines()]

    assert masked(got) == masked(want), where
    g = [float(t) for t in _NUMBER.findall(got)]
    w = [float(t) for t in _NUMBER.findall(want)]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=where)


@pytest.fixture
def world_of_one():
    """The port on the CPU, the reference on one device, both random
    generators in the state a fresh process starts from (seed 0, nothing
    drawn), as a notebook's kernel starts: tutorial 5 draws without a seed."""
    ht.use_device("cpu")
    saved = hj.get_comm()
    states = hj.random.get_state(), ht.random.get_state()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    hj.random.seed(0)
    ht.random.seed(0)
    try:
        yield
    finally:
        hj.use_comm(saved)
        hj.random.set_state(states[0])
        ht.random.set_state(states[1])


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_tutorial_prints_what_the_reference_prints(name, world_of_one):
    cells = _cells(name)
    want = _run(cells, port=False)
    got = _run(cells, port=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        if name in NUMERIC:
            _same_numbers(_read(g), w, *NUMERIC[name], f"{name} cell {i}:\n{cells[i]}")
        else:
            assert _read(g).splitlines() == w.splitlines(), f"{name} cell {i}:\n{cells[i]}"
    assert sum(w is None for w in want) == (1 if name == "3_internals.ipynb" else 0)
