"""Kernel G's choice of design (ops/kernel_beam.py), decided on the host
from static shapes and pointers with no device read: the block arm
(csrc/beam_block.cu) for the build walk's rounds, the per-pair arm
(csrc/beam_scores.cu) for the seeds, the search's one-block rounds, the
build's selection and reprune and for inputs the block arm cannot copy in
16-byte pieces. CPU tensors always
take the plain version; the per-design launchers refuse them. The block
arm's scratch, kept from launch to launch, is laid out and made ready on
the host (here on CPU tensors). The kernels themselves run in
tests/test_torch_gpu.py on the card."""

import numpy as np
import pytest
import torch

from dingo_tpu_torch.ops import kernel_beam as kb
from dingo_tpu_torch.ops.distance import Metric

torch.set_num_threads(1)


def _inputs(b, c, d, dtype=torch.float32, cap=300, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((cap, d)).astype(np.float32))
    slots = torch.from_numpy(
        rng.integers(-1, cap, (b, c)).astype(np.int32))
    return q, x.to(dtype), slots


@pytest.mark.parametrize("b,c,d,dtype,block", [
    (64, 16384, 768, torch.float32, False),     # the search's rounds
    (256, 16384, 768, torch.bfloat16, True),    # the build walk's rounds
    (256, 16384, 768, torch.uint8, True),
    (65, kb.BLOCK_MIN_SLOTS, 32, torch.float32, True),
    (128, kb.BLOCK_MIN_SLOTS - 1, 32, torch.float32, False),
    (64, 1, 768, torch.float32, False),         # a seed
    (256, 512, 768, torch.float32, False),      # the build's selection
    (1024, 72, 768, torch.float32, False),      # the build's reprune
    (64, 4096, 33, torch.float32, False),       # d off the 16-byte piece
    (64, 4096, 36, torch.bfloat16, False),
    (64, 4096, 40, torch.uint8, False),
    (64 * kb.BLOCK_MAX_BLOCKS, 2048, 32, torch.float32, True),
    (64 * kb.BLOCK_MAX_BLOCKS + 1, 2048, 32, torch.float32, False),
])
def test_design_by_static_shape(b, c, d, dtype, block):
    q = torch.zeros((b, d))
    vecs = torch.zeros((8, d), dtype=dtype)
    slots = torch.zeros((b, c), dtype=torch.int32)
    assert kb.takes_block_arm(q, vecs, slots) is block


def test_scratch_over_the_budget_takes_the_pair_arm():
    """The block arm's dots buffer is sized for the worst case (64 x
    min(cap, 64 C) floats a query block): past BLOCK_MAX_SCRATCH_BYTES the
    launch takes the per-pair arm."""
    q = torch.empty((64 * 16, 32))
    slots = torch.empty((64 * 16, 16384), dtype=torch.int32)
    small = torch.empty((100_000, 32))
    assert kb.takes_block_arm(q, small, slots)
    words = 16 * 64 * kb._block_dcap(2_000_000, 16384)
    assert 4 * words > kb.BLOCK_MAX_SCRATCH_BYTES
    big = torch.empty((2_000_000, 32))
    assert not kb.block_arm_fits(q, big, slots)
    assert not kb.takes_block_arm(q, big, slots)


def test_misaligned_rows_take_the_pair_arm():
    """A row array that does not start on a 16-byte boundary cannot be
    copied in 16-byte pieces: the per-pair arm (its scalar loads)."""
    big = torch.zeros((40 * 64 + 1,))
    vecs = big[1:].view(40, 64)
    q = torch.zeros((128, 64))
    slots = torch.zeros((128, 4096), dtype=torch.int32)
    assert not kb.block_arm_fits(q, vecs, slots)
    assert not kb.takes_block_arm(q, vecs, slots)
    assert kb.takes_block_arm(q, big[:40 * 64].view(40, 64), slots)


@pytest.mark.parametrize("design", ["_scores_block", "_scores_pair"])
def test_design_launchers_refuse_cpu_tensors(design):
    """A per-design launcher launches a kernel or raises: on CPU tensors it
    raises, and no counter moves."""
    g = kb.candidate_scores
    q, vecs, slots = _inputs(64, 2048, 32)
    before = (g.block, g.pair, g.launches)
    with pytest.raises(ValueError):
        getattr(kb, design)(q, vecs, (vecs * vecs).sum(1), slots, Metric.L2)
    assert (g.block, g.pair, g.launches) == before


def test_block_scratch_layout():
    """The scratch as beam_block.cu lays it out: 64 count words, a 64-bit
    map entry a (block, row), the row list, then the dots on a 16-byte
    boundary."""
    head, words = kb._block_words(2, 1000, 256)
    assert head == 64 + 2 * 2 * 1000
    ids = head + 2 * 256
    assert words == -(-ids // 4) * 4 + 2 * 64 * 256
    assert kb._block_words(1, 3, 128) == (70, 200 + 64 * 128)


def test_block_scratch_cleared_at_each_new_layout():
    """The first launch of a layout zeroes the map and sets the counts to
    -1; later launches of that layout take new epochs and clear nothing; a
    new layout clears again, a larger one grows the buffer; the epochs
    start over once they run out."""
    s = kb._Scratch()
    dev = torch.device("cpu")
    assert kb._next_epoch(s, dev, 1, 100, 128) == 1
    head, words = kb._block_words(1, 100, 128)
    assert s.buf.numel() == words
    assert bool((s.buf[:64] == -1).all()) and bool((s.buf[64:head] == 0).all())
    s.buf[:head] = 7                     # a launch's map entries and counts
    assert kb._next_epoch(s, dev, 1, 100, 128) == 2
    assert bool((s.buf[:head] == 7).all())
    buf = s.buf
    assert kb._next_epoch(s, dev, 1, 50, 128) == 1      # smaller: reused
    assert s.buf is buf
    head2 = kb._block_words(1, 50, 128)[0]
    assert bool((s.buf[:64] == -1).all())
    assert bool((s.buf[64:head2] == 0).all())
    assert kb._next_epoch(s, dev, 4, 100, 256) == 1     # larger: grown
    assert s.buf.numel() == kb._block_words(4, 100, 256)[1]
    s.epoch = kb._EPOCH_MAX
    s.buf[:64] = 3
    assert kb._next_epoch(s, dev, 4, 100, 256) == 1
    assert bool((s.buf[:64] == -1).all())


def test_block_scratch_one_a_stream():
    """One scratch a (device, stream): launches on one stream share it,
    another stream gets its own."""
    dev = torch.device("cuda", 0)
    a, b = kb._block_scratch(dev, 11), kb._block_scratch(dev, 12)
    assert a is kb._block_scratch(dev, 11) and a is not b
    kb._scratch.pop((0, 11))
    kb._scratch.pop((0, 12))


@pytest.mark.parametrize("arm", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT,
                                    Metric.COSINE])
def test_cpu_tensors_take_the_plain_version(arm, metric):
    """On CPU tensors the wrapper runs the plain version whatever the
    design would be (two blocks of 2,048 slots a query): the same scores, no
    design counter moves, the dtype arm's launch counter does not move
    either (nothing launched)."""
    g = kb.candidate_scores
    q, x, slots = _inputs(128, 2048, 32, seed=3)
    codec = ()
    if arm == "sq8":
        vmin, scale = torch.full((32,), -4.0), torch.full((32,), 2.0 ** -5)
        vecs = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(3))
        codec = (vmin, scale)
        dec = vecs.float() * scale + vmin
        sqn = (dec.to(torch.bfloat16).float() ** 2).sum(1)
    else:
        vecs = x.to(torch.bfloat16) if arm == "bf16" else x
        sqn = (vecs.float() * vecs.float()).sum(1)
    assert kb.takes_block_arm(q, vecs, slots)
    before = (g.block, g.pair, g.launches, g.launches_bf16, g.launches_sq8)
    got = g(q, vecs, sqn, slots, metric, *codec)
    assert (g.block, g.pair, g.launches, g.launches_bf16,
            g.launches_sq8) == before
    plain = kb.candidate_scores_plain(q, vecs, sqn, slots, metric, *codec)
    assert torch.equal(got, plain)
    assert torch.equal(torch.isneginf(got), slots < 0)
