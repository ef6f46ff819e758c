"""The latent-attention kernels' launch plans and sum orders (CPU).

The CUDA kernels (csrc/attention.cu) take their layout from pure-Python plans
of the shape (`cuda_attention.fwd_plan`, `cuda_attention.bwd_plan`), so what
a warp, a block and a cluster own is checked here without a card: rows and
columns covered once, the card's limits on shared memory, cluster size and
threads kept at every N, shared memory bounded past the widest span. A torch
emulation of each kernel's order of sums (a lane's runs, the warp's
butterfly, the backward's warps, then blocks in rank order, then column
slices, chunk after chunk and group after group where the row is wide) is
held to the plain versions and to the JAX package's Pallas kernels in
interpret mode. The kernels themselves run only on the card (chip_smoke.py);
the test that launches them skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.ops import pallas_attention
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.ops import _build, cuda_attention, cuda_gru, torch_impl

torch.set_num_threads(1)

ALPHA = 0.2
# an H100 SXM: its SMs and the shared memory a block can opt in to (the
# wrappers read the card's own through _build.card_limits)
H100 = (132, 232_448)
PLAN_N = [1, 7, 10, 25, 140, 141, 358, 512, 1024, 7300, 8192, 16384]
EMULATED_N = [10, 25, 140, 150]


def _covers_once(ranges, total):
    seen = np.zeros(total, dtype=np.int64)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= total
        seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("b", [1, 8, 32])
def test_fwd_plan_covers_rows_and_columns_once(b, n):
    sms, _ = H100
    plan = cuda_attention.fwd_plan(b, n, sms)
    assert plan.vec == (4 if n % 4 == 0 else 1)
    assert plan.vec * plan.runs <= cuda_attention.MAX_VALUES
    assert plan.runs & (plan.runs - 1) == 0
    span = 32 * plan.vec * plan.runs
    # a warp's span holds the whole row, or the row is swept span by span
    assert plan.wide == (span < n)
    if not plan.wide:
        assert span // 2 < n or plan.runs == 1
    assert plan.bands * plan.rows_per_warp >= n
    assert plan.blocks * (cuda_attention.FWD_THREADS // 32) >= b * plan.bands
    for bi in range(b):
        assert _covers_once([(i0, i1) for bj, i0, i1 in plan.rows(n, b) if bj == bi], n)
    # one wave: the warps of the plan fit FWD_WARPS_PER_SM an SM (up to one
    # short band a batch element)
    assert b * plan.bands <= sms * cuda_attention.FWD_WARPS_PER_SM + b
    assert cuda_attention.fwd_plan(b, n, sms, vec_ok=False).vec == 1


@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("b", [1, 8, 32])
def test_bwd_plan_keeps_the_cards_limits_at_any_n(b, n):
    sms, smem = H100
    plan = cuda_attention.bwd_plan(b, n, sms, smem)
    values = plan.vec * plan.runs
    assert plan.vec == (4 if n % 4 == 0 else 1)
    assert plan.chunked == (n > 32 * cuda_attention.MAX_VALUES)
    if plan.chunked:
        assert values == cuda_attention.BWD_CHUNK_VALUES
    else:
        assert plan.span >= n and values <= cuda_attention.MAX_VALUES
    assert 1 <= plan.cluster <= cuda_attention.MAX_CLUSTER
    assert 1 <= plan.warps and plan.threads % 32 == 0
    assert plan.threads <= cuda_attention.bwd_max_threads(values, plan.chunked) <= 1024
    # blocks own bands of rows, none of them empty, and slices of columns
    assert plan.cluster * plan.rows_per_block >= n > (plan.cluster - 1) * plan.rows_per_block
    width = plan.span if plan.chunked else n
    assert plan.cluster * plan.slice >= width
    # the warps' partials and the received slices (two buffers when chunked)
    bufs = 2 if plan.chunked else 1
    assert plan.smem == 4 * (plan.warps * plan.span + bufs * plan.cluster * plan.slice)
    assert plan.smem <= smem
    # at most 36 KB at any n: past the widest span (1024 columns) the chunked
    # route's shared memory no longer grows with n
    assert plan.smem <= 36_864
    if plan.chunked:
        assert plan.smem == 4 * (32 * 256 + 2 * 8 * 32)
    rows = [i for c in range(plan.cluster) for w in range(plan.warps)
            for i in plan.warp_rows(n, c, w)]
    assert sorted(rows) == list(range(n))


def test_bwd_plan_is_one_launch_of_a_cluster_a_batch_element():
    plan = cuda_attention.bwd_plan(32, 140, *H100)
    # the flagship: 8 blocks of 18 rows, 9 warps of 2 rows; 16-byte loads
    assert (plan.cluster, plan.rows_per_block, plan.warps, plan.vec, plan.runs) == (
        8, 18, 9, 4, 2)
    assert not plan.chunked
    a, b = (cuda_attention.bwd_plan(1, n, *H100) for n in (8192, 16384))
    assert a.smem == b.smem and a.cluster == b.cluster == cuda_attention.MAX_CLUSTER


# --- torch emulations of the kernels' order of sums ---


def _pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _lane_sums(x, vec, runs):
    """x [..., chunks * 32 * vec * runs] -> [..., 32]: each lane's sum of its
    runs, chunk by chunk, in (run, column) order (csrc/attention.cu
    `run_col`)."""
    xs = x.reshape(*x.shape[:-1], -1, runs, 32, vec)
    acc = torch.zeros(*x.shape[:-1], 32, dtype=x.dtype)
    for ch in range(xs.shape[-4]):
        for t in range(runs):
            for v in range(vec):
                acc = acc + xs[..., ch, t, :, v]
    return acc


def _butterfly(x, op):
    """The warp's shuffle butterfly over the lanes [..., 32]; every lane ends
    with the same value."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[..., idx ^ o])
    return x[..., 0]


def emulate_fwd(key, query, alpha, plan):
    """The forward's sums: a lane's runs, then the butterfly; the max over
    the row, exp once an element, the row scaled by the reciprocal of its
    sum. A wide plan sweeps spans of its width (the same order). key [B, M]
    may be a row block of query [B, N]'s nodes."""
    n = query.shape[1]
    span = 32 * plan.vec * plan.runs
    width = -(-n // span) * span
    q = _pad(query, width)
    s = key[:, :, None] + q[:, None, :]
    s = torch.where(s >= 0, s, alpha * s)
    valid = torch.arange(width) < n
    m = s.masked_fill(~valid, -torch.inf).amax(dim=-1)  # a max has one value in any order
    e = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    total = _butterfly(_lane_sums(e, plan.vec, plan.runs), torch.add)
    return (e * (1.0 / total)[..., None])[..., :n]


def emulate_bwd(key, query, p, g, alpha, plan):
    """The backward's sums in the kernel's order. Register route: a row's dot
    and dkey by the butterfly over the lanes' runs; a warp's column partials
    over its rows in turn; a block's partials summed warp by warp; a
    column's sum over the blocks of the cluster in rank order. Chunked route:
    a warp's rows in groups of 32, a dot pass over each group's rows, then
    chunk by chunk the same sums, a row's dkey added chunk after chunk and a
    column's cluster sums added to dquery group after group. key [B, M] may
    be a row block of query [B, N]'s nodes: its blocks split the M rows."""
    b, m = key.shape
    n = query.shape[1]
    span = plan.span
    chunks = -(-n // span) if plan.chunked else 1
    width = chunks * span
    pp, gg, q = _pad(p, width), _pad(g, width), _pad(query, width)
    gp = gg * pp
    dot = _butterfly(_lane_sums(gp, plan.vec, plan.runs), torch.add)  # [B, N]
    dl = gp - pp * dot[..., None]
    pre = key[:, :, None] + q[:, None, :]
    dpre = torch.where(pre >= 0, dl, alpha * dl)
    dkey = torch.zeros(b, m)
    dquery = torch.zeros(b, width)
    warp_rows = [[plan.warp_rows(m, c, w) for w in range(plan.warps)]
                 for c in range(plan.cluster)]
    per_warp = max(len(r) for blk in warp_rows for r in blk)
    groups = -(-per_warp // 32) if plan.chunked else 1
    for grp in range(groups):
        for ch in range(chunks):
            cols = slice(ch * span, (ch + 1) * span)
            blocks = []
            for c in range(plan.cluster):
                parts = []
                for rows in warp_rows[c]:
                    acc = torch.zeros(b, span)
                    for i in (rows[grp * 32:(grp + 1) * 32] if plan.chunked else rows):
                        acc = acc + dpre[:, i, cols]
                    parts.append(acc)
                total = parts[0]
                for part in parts[1:]:
                    total = total + part
                blocks.append(total)
            s = blocks[0]
            for blk in blocks[1:]:
                s = s + blk
            dquery[:, cols] = s if grp == 0 else dquery[:, cols] + s
    if plan.chunked:
        for ch in range(chunks):
            cols = slice(ch * span, (ch + 1) * span)
            dkey = dkey + _butterfly(_lane_sums(dpre[..., cols], plan.vec, plan.runs),
                                     torch.add)
    else:
        dkey = _butterfly(_lane_sums(dpre, plan.vec, plan.runs), torch.add)
    return dkey, dquery[:, :n]


def _chunked(plan, n, runs=1, vec=1, warps=1, cluster=2):
    """`plan` on the chunked route's order with a span of 32 * vec * runs
    columns (the kernel's is 256; a narrower one walks several chunks and
    groups at a small n): the emulation's order, not a kernel's plan."""
    rows_per_block = -(-n // cluster)
    span = 32 * vec * runs
    return plan._replace(chunked=True, vec=vec, runs=runs, warps=warps, cluster=cluster,
                         rows_per_block=rows_per_block, slice=-(-span // cluster))


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    key = rng.standard_normal((b, n)).astype(np.float32)
    query = rng.standard_normal((b, n)).astype(np.float32)
    g = rng.standard_normal((b, n, n)).astype(np.float32)
    return key, query, g


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("n", EMULATED_N)
def test_fwd_emulation_matches_the_pallas_forward(interpret, n):
    key, query, _ = _inputs(3, n, 40 + n)
    want = np.asarray(pallas_attention._forward_kq(jnp.asarray(key), jnp.asarray(query),
                                                   ALPHA))
    k, q = torch.from_numpy(key), torch.from_numpy(query)
    for plan in (cuda_attention.fwd_plan(3, n, H100[0]),
                 cuda_attention.fwd_plan(3, n, H100[0])._replace(vec=1, runs=1, wide=True)):
        got = emulate_fwd(k, q, ALPHA, plan)
        # outputs <= 1; exp and the reciprocal differ by an ulp or two
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), torch_impl.attention_from_kq(k, q, ALPHA),
                                   atol=1e-6)


@pytest.mark.parametrize("n", EMULATED_N)
def test_bwd_emulation_matches_the_plain_and_pallas_backward(interpret, n):
    key, query, g = _inputs(3, n, 50 + n)
    p = pallas_attention._forward_kq(jnp.asarray(key), jnp.asarray(query), ALPHA)
    want = pallas_attention._bwd(ALPHA, (jnp.asarray(key), jnp.asarray(query), p),
                                 jnp.asarray(g))
    k, q, pt, gt = (torch.from_numpy(np.array(a)) for a in (key, query, p, g))
    plain = torch_impl.attention_kq_bwd(k, q, pt, gt, ALPHA)
    plan = cuda_attention.bwd_plan(3, n, *H100)
    for route in (plan, _chunked(plan, n), _chunked(plan, n, runs=2, warps=2, cluster=3)):
        got = emulate_bwd(k, q, pt, gt, ALPHA, route)
        for g_, w_, p_ in zip(got, want, plain):
            # sums of n terms below 1 in magnitude, in another order
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5)
            np.testing.assert_allclose(g_.numpy(), p_.numpy(), atol=1e-5)


def test_chunked_emulation_walks_several_chunks_and_groups():
    """At n = 150 on a 32-column span, 2 blocks of one warp: 5 chunks, 3
    groups of 32 rows a warp (the order a wide row takes on the card)."""
    n = 150
    plan = _chunked(cuda_attention.bwd_plan(2, n, *H100), n)
    assert -(-n // plan.span) == 5 and -(-plan.rows_per_block // 32) == 3
    key, query, g = (torch.from_numpy(a) for a in _inputs(2, n, 60))
    p = torch_impl.attention_from_kq(key, query, ALPHA)
    for got, want in zip(emulate_bwd(key, query, p, g, ALPHA, plan),
                         torch_impl.attention_kq_bwd(key, query, p, g, ALPHA)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.fixture(autouse=True)
def _launch_counts_restored():
    """The wrappers count the launches the fake C entries below stand for:
    each test leaves the counts as it found them, for the tests after it in
    this process."""
    before = ops.launches()
    yield
    for name, n in before.items():
        ops.KERNELS[name].launches = n


class _Fake:
    """A C function that records its arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("n", [140, 141, 1100])
def test_wrappers_hand_the_kernels_their_plans(monkeypatch, n):
    """Each wrapper is one C entry a call, handed its plan (the backward no
    scratch tensor: the six arrays and the plan)."""
    b = 2
    fakes = {}
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(_build, "card_limits", lambda device: H100)
    monkeypatch.setattr(cuda_attention, "_fn", lambda name: fakes.setdefault(name, _Fake()))
    key, query, g = (torch.from_numpy(a) for a in _inputs(b, n, 80))
    out = cuda_attention._launch_fwd(key, query, ALPHA)
    cuda_attention._launch_bwd(key, query, out, g, ALPHA)
    assert sorted(fakes) == ["attention_kq_bwd", "attention_kq_fwd"]
    vec_ok = all(t.data_ptr() % 16 == 0 for t in (query, out, g))
    fp = cuda_attention.fwd_plan(b, n, H100[0], query.data_ptr() % 16 == 0)
    bp = cuda_attention.bwd_plan(b, n, *H100, vec_ok)
    (fargs,) = fakes["attention_kq_fwd"].calls
    (bargs,) = fakes["attention_kq_bwd"].calls
    assert len(fargs) == len(cuda_attention._ARGTYPES["attention_kq_fwd"])
    assert len(bargs) == len(cuda_attention._ARGTYPES["attention_kq_bwd"])
    # (B, M, N): the square call's rows are its columns
    assert fargs[:6] == (key.data_ptr(), query.data_ptr(), out.data_ptr(), b, n, n)
    assert fargs[7:13] == (fp.vec, fp.runs, int(fp.wide), fp.rows_per_warp, fp.bands,
                           fp.blocks)
    assert bargs[:4] == (key.data_ptr(), query.data_ptr(), out.data_ptr(), g.data_ptr())
    assert bargs[6:9] == (b, n, n)
    assert bargs[10:18] == (bp.vec, bp.runs, int(bp.chunked), bp.cluster, bp.threads,
                            bp.rows_per_block, bp.slice, bp.smem)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels run only there (chip_smoke.py "
                    "holds them on every run)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 140), (32, 25), (32, 141), (1, 7300)])
def test_kernels_match_the_plain_versions_on_the_card(card, b, n):
    key, query, g = (torch.from_numpy(a).to(card) for a in _inputs(b, n, 70))
    out = cuda_attention.attention_kq(key, query, ALPHA)
    want = cuda_attention.attention_kq_plain(key, query, ALPHA)
    torch.testing.assert_close(out, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    got = cuda_attention.attention_kq_bwd(key, query, want, g, ALPHA)
    again = cuda_attention.attention_kq_bwd(key, query, want, g, ALPHA)
    for a, a2, w_ in zip(got, again, cuda_attention.attention_kq_bwd_plain(key, query, want,
                                                                          g, ALPHA)):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, w_, atol=1e-5 * w_.abs().max().item(), rtol=0)
