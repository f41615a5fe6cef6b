"""The `fleet_drift` kernel's bucket rule and counting layout, emulated on
the CPU and held to the reference rule.

The kernel (csrc/fleet_drift.cu) finds a token's bucket without a hardware
division, from constants that the wrapper computes on the host
(`fleet_drift.bucket_plan`): a lookup table of the clipped tokens, the
reciprocal M = floor(2^64 / d) + 1 of vocab or of the bucket count, or a
mask. Here a numpy emulation of each device formula (32-bit unsigned
products, the high 64 bits of a 64 x 64-bit product) is fed the wrapper's
constants and held, for every path that applies, to the port's
`ref.bucket_index` and to the JAX `_bucket_idx`
(src/repro/kernels/fleet_drift.py) on every token in [-2, vocab + 2],
INT32_MIN and INT32_MAX, over vocab 1, 3, 63, 64, 65, 50304 and 2^31 - 1
(its range sampled) and buckets 1, 7, 64, 128 and 1536, and with vocab 0
for power-of-two and other bucket counts. The JAX rule runs with 64-bit
integers: on int32 tokens its `t * buckets` wraps once t reaches 2^31 /
buckets. Then the kernel's counting (a warp per row, each lane reading
its share of the row as 16-byte groups, the first two issued ahead, or
token by token where T is not a multiple of 4; the grid's warps striding
over the rows) is emulated on the drift plane's bigram tokens, uniform
and negative tokens, at several T and grid sizes, and must read every
token once and give bincount's counts exactly. The kernel itself runs on
the card: the `gpu`-marked test below and `chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fleet_drift import _bucket_idx  # noqa: E402
from repro_torch.data.streams import DomainBank  # noqa: E402
from repro_torch.kernels import fleet_drift as fd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
VOCABS = [1, 3, 63, 64, 65, 50304, 2 ** 31 - 1]
BUCKETS = [1, 7, 64, 128, 1536]
U32 = np.uint64(0xFFFFFFFF)


def _umul64hi(u, magic: int):
    """High 64 bits of u * magic for u < 2^32 (uint64 array) and magic <
    2^64, as __umul64hi computes them: magic split into 32-bit halves, each
    partial product fits 64 bits."""
    mh, ml = np.uint64(magic >> 32), np.uint64(magic & 0xFFFFFFFF)
    return (u * mh + ((u * ml) >> np.uint64(32))) >> np.uint64(32)


def emulate(tokens, buckets: int, vocab: int, bp: fd.BucketPlan):
    """The device formula of csrc/fleet_drift.cu `bucket_of` for int32
    tokens, in numpy with the kernel's integer widths."""
    t = np.asarray(tokens, np.int32)
    B = buckets
    if bp.mode == fd.MASK:
        return (t & np.int32(B - 1)).astype(np.int64)
    if bp.mode == fd.MODR:
        tu = t.astype(np.int64).astype(np.uint64) & U32       # as unsigned
        u = np.where(t < 0, (np.uint64(2 ** 32) - tu) & U32, tu)
        q = _umul64hi(u, bp.magic) & U32
        r = (u - q * np.uint64(B)) & U32
        return np.where((t < 0) & (r != 0), B - r.astype(np.int64),
                        r.astype(np.int64))
    c = np.minimum(np.maximum(t, 0), vocab)               # clip first
    if bp.mode == fd.LUT:
        return bp.lut[c].astype(np.int64)
    if bp.mode == fd.RECIP:
        u = (c.astype(np.uint64) * np.uint64(B)) & U32     # 32-bit product
        q = (_umul64hi(u, bp.magic) & U32).astype(np.int64)
        return np.minimum(q, B - 1)
    q = c.astype(np.int64) * B // vocab                    # WIDE
    return np.minimum(q, B - 1)


def _tokens(vocab: int):
    """Every token in [-2, vocab + 2] (for 2^31 - 1 the edges and a sample
    of the range), with INT32_MIN and INT32_MAX."""
    if vocab < 2 ** 20:
        t = np.arange(-2, vocab + 3, dtype=np.int64)
    else:
        rng = np.random.default_rng(vocab % 1000)
        t = np.concatenate([np.arange(-2, 3), np.arange(vocab - 2, vocab + 3),
                            rng.integers(0, vocab, size=200_000)])
    t = np.concatenate([t, [INT32_MIN, INT32_MAX]])
    return np.clip(t, INT32_MIN, INT32_MAX).astype(np.int32)


def _reference(tokens, buckets, vocab):
    """ref.bucket_index (int64) and the JAX _bucket_idx with 64-bit
    integers, which must agree."""
    want = tref.bucket_index(torch.from_numpy(tokens), buckets,
                             vocab).numpy()
    with jax.enable_x64(True):
        jwant = np.asarray(_bucket_idx(jnp.asarray(tokens.astype(np.int64)),
                                       buckets, vocab))
    np.testing.assert_array_equal(want, jwant)
    return want


def _paths(buckets: int, vocab: int):
    """Every bucket path that applies to (buckets, vocab), with the
    wrapper's constants: the one `bucket_plan` picks and the others whose
    range also covers it."""
    if vocab:
        out = [fd.BucketPlan(fd.WIDE)]
        if vocab < 2 ** 20:                  # a table of 4 MB and more
            out.append(fd.BucketPlan(fd.LUT,
                                     lut=fd.bucket_table(buckets, vocab)))
        if 2 <= vocab and vocab * buckets < 2 ** 32:
            out.append(fd.BucketPlan(fd.RECIP, magic=fd.reciprocal(vocab)))
    else:
        out = []
        if buckets & (buckets - 1) == 0:
            out.append(fd.BucketPlan(fd.MASK))
        if buckets >= 2:
            out.append(fd.BucketPlan(fd.MODR, magic=fd.reciprocal(buckets)))
    chosen = fd.bucket_plan(buckets, vocab)
    assert any(p.mode == chosen.mode and p.magic == chosen.magic
               for p in out), (buckets, vocab, chosen.mode)
    return out


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("vocab", VOCABS)
def test_every_path_gives_the_reference_bucket(vocab, buckets):
    toks = _tokens(vocab)
    want = _reference(toks, buckets, vocab)
    for bp in _paths(buckets, vocab):
        got = emulate(toks, buckets, vocab, bp)
        np.testing.assert_array_equal(got, want, err_msg=str(bp.mode))


@pytest.mark.parametrize("buckets", [1, 2, 7, 48, 64, 100, 1536])
def test_vocab_zero_floor_modulo(buckets):
    """Modulo hashing: a mask for a power-of-two bucket count, else the
    reciprocal of the count on |t| with the sign fixed; both floor modulo
    for negative tokens, INT32_MIN included."""
    rng = np.random.default_rng(buckets)
    toks = np.concatenate([np.arange(-3 * buckets - 2, 3 * buckets + 3),
                           rng.integers(INT32_MIN, INT32_MAX, size=100_000),
                           [INT32_MIN, INT32_MIN + 1, INT32_MAX - 1,
                            INT32_MAX]]).astype(np.int32)
    want = _reference(toks, buckets, 0)
    auto = fd.bucket_plan(buckets, 0)
    assert auto.mode == (fd.MASK if buckets & (buckets - 1) == 0
                         else fd.MODR)
    for bp in _paths(buckets, 0):
        np.testing.assert_array_equal(emulate(toks, buckets, 0, bp), want)


def test_wrapper_constants():
    """The table is batch_token_histogram's; the reciprocal is
    floor(2^64 / d) + 1; the table serves vocab up to LUT_MAX_VOCAB, the
    reciprocal while vocab * buckets < 2^32, the 64-bit division beyond;
    vocab 0 takes the mask for a power-of-two count (1 included)."""
    bp = fd.bucket_plan(64, 64)
    assert bp.mode == fd.LUT and bp.lut.dtype == np.int32
    np.testing.assert_array_equal(bp.lut, np.minimum(np.arange(65), 63))
    assert fd.bucket_plan(64, 50304) == fd.BucketPlan(
        fd.RECIP, magic=2 ** 64 // 50304 + 1)
    assert fd.bucket_plan(7, fd.LUT_MAX_VOCAB).mode == fd.LUT
    assert fd.bucket_plan(7, fd.LUT_MAX_VOCAB + 1).mode == fd.RECIP
    assert fd.bucket_plan(64, 2 ** 26 - 1).mode == fd.RECIP
    assert fd.bucket_plan(64, 2 ** 26).mode == fd.WIDE
    assert fd.bucket_plan(1536, 2 ** 31 - 1).mode == fd.WIDE
    assert fd.bucket_plan(64, 0).mode == fd.MASK
    assert fd.bucket_plan(1, 0).mode == fd.MASK
    assert fd.bucket_plan(48, 0) == fd.BucketPlan(fd.MODR,
                                                  magic=2 ** 64 // 48 + 1)
    for d in (0, 1, 2 ** 31):
        with pytest.raises(ValueError):
            fd.reciprocal(d)


# ---------------------------------------------------------------------------
# the counting
# ---------------------------------------------------------------------------
def _positions(T: int):
    """The token positions a warp's 32 lanes read of a T-token row, in
    csrc/fleet_drift.cu's order: with 16-byte loads (T a multiple of 4),
    lane l's groups l + 32 u for the kPrefetch = 2 issued ahead, then the
    rest in runs of kUnroll = 8, each masked by the step count and the
    row's n4 = T / 4 groups; otherwise tokens l, l + 32, ..."""
    lanes = range(32)
    if T % 4:
        return [k for lane in lanes for k in range(lane, T, 32)]
    n4 = T // 4
    steps = -(-n4 // 32)
    groups = [u * 32 + lane for lane in lanes for u in range(2)
              if u < steps and u * 32 + lane < n4]
    for s0 in range(2, steps, 8):
        groups += [(s0 + u) * 32 + lane for lane in lanes for u in range(8)
                   if s0 + u < steps and (s0 + u) * 32 + lane < n4]
    return [4 * g + e for g in groups for e in range(4)]


def _rows(N: int, blocks: int):
    """The rows the grid's warps (8 a block) count, warp w rows w, w +
    8 blocks, ..."""
    stride = 8 * blocks
    return [r for w in range(stride) for r in range(w, N, stride)]


def emulate_counts(tokens, buckets: int, vocab: int, blocks: int):
    """csrc/fleet_drift.cu's counts for `tokens` (N, T) on a grid of
    `blocks` blocks: every row a warp visits adds one to its counter of
    each token's bucket at the positions the warp reads."""
    N, T = tokens.shape
    idx = emulate(tokens, buckets, vocab, fd.bucket_plan(buckets, vocab))
    pos = np.asarray(_positions(T), np.int64)
    out = np.zeros((N, buckets), np.int64)
    for r in _rows(N, blocks):
        np.add.at(out[r], idx[r, pos], 1)
    return out


def _bigram_tokens(n, T=256, seed=0):
    """The drift plane's tokens: bigram chains of DomainBank(64, 6,
    dim=4), T // 32 sequences of 32 per stream."""
    bank = DomainBank(64, 6, dim=4, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return bank.sample(2, rng, n * (T // 32), 32).reshape(n, T)


@pytest.mark.parametrize("T", [37, 256, 1000, 2052])
@pytest.mark.parametrize("kind", ["bigram", "uniform", "mask", "modulo",
                                  "wide"])
def test_counting_reads_every_token_once(kind, T):
    rng = np.random.default_rng(5)
    N, B = 24, 64
    if kind == "bigram":
        toks, vocab = _bigram_tokens(N, T=-(-T // 32) * 32)[:, :T], 64
    elif kind == "uniform":
        toks, vocab = rng.integers(0, 50304, size=(N, T)), 50304
    elif kind == "wide":
        toks, vocab = rng.integers(INT32_MIN, INT32_MAX, size=(N, T)), \
            INT32_MAX
    else:
        toks, vocab = rng.integers(-5000, 5000, size=(N, T)), 0
        B = 64 if kind == "mask" else 48
    toks = toks.astype(np.int32)
    assert sorted(_positions(T)) == list(range(T))
    want = np.stack([np.bincount(r, minlength=B) for r in
                     tref.bucket_index(torch.from_numpy(toks), B,
                                       vocab).numpy()])
    for blocks in (1, 2, 3):
        assert sorted(_rows(N, blocks)) == list(range(N))
        got = emulate_counts(toks, B, vocab, blocks)
        np.testing.assert_array_equal(got, want)
        assert (got.sum(axis=1) == T).all()


def test_bigram_rows_hit_few_buckets():
    """Why same-address atomics serialise on the plane's tokens: a
    256-token row falls in a few dozen of the 64 buckets at most."""
    toks = _bigram_tokens(64)
    distinct = [len(np.unique(r)) for r in toks]
    assert max(distinct) <= 40, distinct


def test_shared_memory():
    """A warp's counters (one per bucket) and the lookup table fit a
    block at every bucket count and table the wrapper takes; smem_bytes
    mirrors the kernel's."""
    assert fd.smem_bytes(64, 65) == 4 * (8 * 64 + 65)
    assert fd.smem_bytes(1536) == 4 * 8 * 1536
    assert fd.smem_bytes(fd.MAX_BUCKETS,
                         fd.LUT_MAX_VOCAB + 1) <= fd.MAX_SMEM_BYTES


@pytest.mark.gpu
def test_cuda_every_path_and_layout_matches_plain_version():
    """On the card: each bucket path the wrapper picks against the plain
    version, histograms exact (needs a CUDA device and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    modes = set()
    for B, vocab, lo, hi in ((64, 64, -2, 66), (64, 50304, 0, 50304),
                             (64, INT32_MAX, INT32_MIN, INT32_MAX),
                             (64, 0, -2 ** 20, 2 ** 20),
                             (48, 0, -2 ** 20, 2 ** 20)):
        modes.add(fd.bucket_plan(B, vocab).mode)
        for T in (256, 37):
            toks = torch.from_numpy(rng.integers(lo, hi, size=(300, T),
                                                 dtype=np.int32)).cuda()
            ref = torch.rand((300, B), device="cuda")
            ws, wh = tref.fleet_drift_ref(toks, ref, buckets=B, vocab=vocab)
            s, h = fd.fleet_drift(toks, ref, buckets=B, vocab=vocab)
            np.testing.assert_array_equal(h.cpu().numpy(), wh.cpu().numpy())
            np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(),
                                       atol=1e-5, rtol=0)
    assert modes == {fd.WIDE, fd.LUT, fd.RECIP, fd.MASK, fd.MODR}
