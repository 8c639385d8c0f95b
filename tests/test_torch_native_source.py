"""The port's native host library is built from its own copy of the C++
source, and that copy is the JAX package's file byte for byte, so the
parity tests that load both libraries compare like with like."""

from pathlib import Path

from sequila_tpu_torch.native import loader

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "sequila_tpu" / "native" / "src" / "sequila_native.cc"


def test_copy_equals_the_reference_source():
    assert Path(loader._SRC).read_bytes() == REFERENCE.read_bytes()


def test_source_lies_inside_the_port():
    src = Path(loader._SRC).resolve()
    port = (REPO / "sequila_tpu_torch").resolve()
    assert src.is_relative_to(port), src
    assert src.is_file()
