"""``repro_torch.bench.variants``, the kernel-variant timer, on the CPU:
every variant's substitutions still match the kernels' sources (so no
variant silently times the unchanged kernel), and timing refuses to run
without a card.  Building and timing the variants happens on the card.
"""
import pytest
import torch

from repro_torch.bench import variants as V
from repro_torch.kernels import _build


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models run many small ops, which
    the thread pools of several test workers on a shared CPU slow down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(V.VARIANTS))
def test_variant_source_applies(name):
    src, subs = V.VARIANTS[name]
    text = V.variant_source(name)
    base = (_build.CSRC / src).read_text()
    assert (text != base) == bool(subs)
    for _, new in subs:
        assert new in text


def test_stale_substitution_raises(monkeypatch):
    monkeypatch.setitem(V.VARIANTS, "stale",
                        ("rmsnorm.cu", [("no such text", "x")]))
    with pytest.raises(ValueError, match="found 0 times"):
        V.variant_source("stale")


def test_measure_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        V.measure(["ssd"])
