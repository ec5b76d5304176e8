"""The port's entry points run on the CUDA card unless the caller names
a device.

Without a device they land on the current card where there is one and
raise ``RuntimeError`` where there is none; with ``device="cpu"`` they
land on the CPU.  Whether there is a card is decided inside each test.
The card's presence and absence are also simulated (``torch.cuda``'s
``is_available`` and ``current_device`` patched) for the constructors,
which hold no tensors until they are used, so both branches run on any
machine.
"""

import pytest
import torch

from new_bloom_filter_repo_tpu_torch import graft_entry
from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
    BloomFilterCompressor,
)
from new_bloom_filter_repo_tpu_torch.models.blocked_pipeline import (
    BlockedDecoder,
    BlockedEncoder,
)
from new_bloom_filter_repo_tpu_torch.models.image_text import BloomCompressor
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.parallel.mesh import home_device

# name -> device=... -> the device the entry point settled on
CONSTRUCTORS = {
    "ImprovedVideoCompressor":
        lambda **kw: ImprovedVideoCompressor(**kw).device,
    "ImprovedVideoCompressor.bloom_compressor":
        lambda **kw: ImprovedVideoCompressor(**kw).bloom_compressor.device,
    "BlockedEncoder": lambda **kw: BlockedEncoder(**kw).device,
    "BlockedDecoder": lambda **kw: BlockedDecoder(**kw).device,
    "BloomFilterCompressor": lambda **kw: BloomFilterCompressor(**kw).device,
    "image_text.BloomCompressor":
        lambda **kw: BloomCompressor(**kw)._codec.device,
    "home_device": lambda **kw: home_device(None, **kw),
}
ENTRY_POINTS = {
    **CONSTRUCTORS,
    "graft_entry.entry": lambda **kw: graft_entry.entry(**kw)[1][0].device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_named_means_the_card(name):
    """On a machine with a card: the card; without one: RuntimeError
    naming the way to the CPU, never a silent CPU run."""
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_when_asked(name):
    assert ENTRY_POINTS[name](device="cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_default_is_the_current_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert CONSTRUCTORS[name]() == torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[name]()
