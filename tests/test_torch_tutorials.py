"""The reference's tutorials 1-3 (tutorials/local) run through the port.

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

Tutorial 3's cell that prints ``a.larray_padded.sharding`` is skipped: a
``jax.sharding`` object has no counterpart in the port (a rank's buffer is
a plain tensor; its layout is ``lshape_map``, which the tutorial prints)."""

import contextlib
import io
import json
import re
from pathlib import Path

import jax
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht

TUTORIALS = Path(__file__).resolve().parents[1] / "tutorials" / "local"
NOTEBOOKS = ["1_intro.ipynb", "2_basics.ipynb", "3_internals.ipynb"]
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


@pytest.fixture
def world_of_one():
    """The port on the CPU, the reference on one device."""
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_tutorial_prints_what_the_reference_prints(name, world_of_one):
    cells = _cells(name)
    want = _run(cells, port=False)
    got = _run(cells, port=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        assert _read(g).splitlines() == w.splitlines(), f"{name} cell {i}:\n{cells[i]}"
    assert sum(w is None for w in want) == (1 if name == "3_internals.ipynb" else 0)
