"""The kernel wrappers' traced branch (``kernels.build.traced``): on
``FakeTensorMode`` tensors off the CPU (the dry run's ``meta`` device)
each of the seven wrappers returns what its kernel returns -- the plain
version's shapes and dtypes, checked against the plain version traced on
fake CPU tensors -- allocates what its launch allocates (split-K
partials, split buffers, the ``boolean_matmul`` wᵀ copy, counted by
``MemTracker``), builds and launches nothing, and counts
``fake_launches``, never ``launches`` / ``tc_launches`` / ``cc_launches``.
Fake CPU tensors still take the plain version (the dry run's
``--calibrate`` counts its FLOPs).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.kernels import (KERNELS, boolean_matmul,
                                 boolean_weight_bwd, flash_attention_fwd,
                                 packed_xnor_gemv, packed_xnor_matmul,
                                 paged_flash_decode, paged_prefix_attention)
from repro_torch.kernels import build
from repro_torch.kernels.boolean_bwd import boolean_weight_bwd_plain
from repro_torch.kernels.boolean_matmul import boolean_matmul_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.packed_xnor import (gemv_source_tiles, gemv_split,
                                             gemv_tc_plan,
                                             packed_xnor_gemv_plain,
                                             packed_xnor_matmul_plain)
from repro_torch.kernels.paged_attention import (
    attention_source_tiles, decode_split, paged_flash_decode_plain,
    paged_prefix_attention_plain)

I32, I8, BF16, F32 = torch.int32, torch.int8, torch.bfloat16, torch.float32


def _counts():
    return {k.__name__: (getattr(k, "launches", 0),
                         getattr(k, "tc_launches", 0),
                         getattr(k, "cc_launches", 0),
                         k.fake_launches) for k in KERNELS}


def _make(device, specs):
    return [torch.zeros(s, dtype=d, device=device) if isinstance(s, tuple)
            else s for s, d in specs]


def _run(wrapper, plain, specs, kwargs=None):
    """-> (traced output, plain output traced on the CPU, peak bytes the
    traced call allocated); the counters checked."""
    kwargs = kwargs or {}
    before = _counts()
    with FakeTensorMode():
        args = _make("meta", specs)
        mt = MemTracker()
        with mt:
            got = wrapper(*args, **kwargs)
        peak = mt.get_tracker_snapshot("peak").get(torch.device("meta"), {})
        want = plain(*_make("cpu", specs), **kwargs)
    after = _counts()
    name = wrapper.__name__
    for k in after:
        launches, tc, cc, fake = after[k]
        assert (launches, tc, cc) == before[k][:3], k
        assert fake == before[k][3] + (k == name), k
    assert got.device.type == "meta" and want.device.type == "cpu"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    return got, want, peak.get("Total", 0)


@pytest.mark.parametrize("M,K,N,dt", [(8, 2304, 4096, BF16),
                                      (128, 2304, 9216, BF16),
                                      (5, 100, 40, F32)])
def test_packed_xnor_gemv(M, K, N, dt):
    Kw = -(-K // 32)
    _, _, peak = _run(packed_xnor_gemv, packed_xnor_gemv_plain,
                      [((M, K), dt), ((Kw, N), I32)], {"k_valid": K})
    if dt == BF16 and K % 8 == 0:
        ksplit = gemv_tc_plan(M, Kw, N, gemv_source_tiles())[1]
    else:
        ksplit = gemv_split(M, Kw, N)[0]
    assert peak == 4 * M * N * (1 + (ksplit if ksplit > 1 else 0))


@pytest.mark.parametrize("M,Kw,N", [(800, 9, 64), (100, 36, 128),
                                    (3, 1, 5)])
def test_packed_xnor_matmul(M, Kw, N):
    _, _, peak = _run(packed_xnor_matmul, packed_xnor_matmul_plain,
                      [((M, Kw), I32), ((Kw, N), I32)],
                      {"k_valid": 32 * Kw - 3})
    assert peak == 4 * M * N


@pytest.mark.parametrize("L,KV,R,hd,page,C,dt", [
    (8, 4, 4, 256, 16, 64, BF16),       # tensor cores, bf16 pool
    (8, 8, 6, 128, 32, 32, I8),         # tensor cores, int8 pool
    (2, 2, 2, 64, 8, 4, F32),           # CUDA cores
])
def test_paged_flash_decode(L, KV, R, hd, page, C, dt):
    n_pages = L * C + 1
    q_dt = F32 if dt == F32 else BF16
    specs = [((L, KV, R, hd), q_dt), ((n_pages, page, KV, hd), dt),
             ((n_pages, page, KV, hd), dt), ((L, C), I32), ((L,), I32)]
    if dt == I8:
        specs += [((n_pages, page, KV), F32)] * 2
    _, _, peak = _run(paged_flash_decode, paged_flash_decode_plain, specs)
    nsplit = decode_split(L, KV, C, build.H100_SMS)
    out = 4 * L * KV * R * hd
    if q_dt == BF16:          # the tensor-core route's merge buffers
        want = out + (4 * L * KV * nsplit * R * (2 + hd) if nsplit > 1
                      else 0)
    else:
        nsplit = -(-C // -(-C // nsplit))
        want = out + 4 * L * KV * nsplit * R * (2 + hd)
    assert peak == want


@pytest.mark.parametrize("H,KV,T,S,hd,page,npp,dt", [
    (16, 4, 256, 256, 256, 16, 32, BF16),
    (8, 2, 100, 128, 128, 16, 8, I8),
    (4, 4, 7, 7, 64, 3, 5, F32),
])
def test_paged_prefix_attention(H, KV, T, S, hd, page, npp, dt):
    q_dt = F32 if dt == F32 else BF16
    n_pages = npp + 2
    specs = [((H, T, hd), q_dt), ((S, KV, hd), q_dt), ((S, KV, hd), q_dt),
             ((n_pages, page, KV, hd), dt), ((n_pages, page, KV, hd), dt),
             ((npp,), I32), (page * 2, None), (npp * page - 1, None),
             (S - 1, None)]
    if dt == I8:
        specs += [((n_pages, page, KV), F32)] * 2
    _run(paged_prefix_attention, paged_prefix_attention_plain, specs,
         {"n_rep": H // KV})


@pytest.mark.parametrize("B,M,N,dt", [(1024, 2304, 4096, BF16),
                                      (64, 96, 40, F32), (7, 13, 5, I8)])
def test_boolean_weight_bwd(B, M, N, dt):
    z_dt = F32 if dt == I8 else dt
    _, _, peak = _run(boolean_weight_bwd, boolean_weight_bwd_plain,
                      [((B, M), dt), ((B, N), z_dt)])
    assert peak == 4 * M * N


@pytest.mark.parametrize("BH,n_rep,S,hd,dt", [(16, 4, 1024, 256, BF16),
                                              (8, 1, 100, 128, BF16),
                                              (4, 2, 33, 64, F32)])
def test_flash_attention_fwd(BH, n_rep, S, hd, dt):
    _, _, peak = _run(flash_attention_fwd, flash_attention_plain,
                      [((BH, S, hd), dt), ((BH // n_rep, S, hd), dt),
                       ((BH // n_rep, S, hd), dt)],
                      {"softcap": 50.0, "n_rep": n_rep})
    assert peak == BH * S * hd * (2 if dt == BF16 else 4)


@pytest.mark.parametrize("M,K,N,fuse", [(100 * 16 * 16, 576, 128, False),
                                        (4096, 1152, 256, True),
                                        (5, 27, 7, False)])
def test_boolean_matmul(M, K, N, fuse):
    _, _, peak = _run(boolean_matmul, boolean_matmul_plain,
                      [((M, K), I8), ((K, N), I8)],
                      {"fuse_threshold": fuse})
    Kp = -(-K // 16) * 16
    y = M * N * (1 if fuse else 4)
    # wᵀ (N, Kp), and x padded to Kp where K is ragged
    assert peak == y + N * Kp + (M * Kp if Kp != K else 0)


def test_traced_plans_read_the_kernels_source():
    """A traced launch plans with the tile constants of the kernels' own
    text (the library reports the same ones on the card): the GEMV's
    words a stage, columns a block and by lane tile the blocks an SM and
    stages; the attention kernels' query and key rows."""
    t = gemv_source_tiles()
    assert (t.ks, t.cols) == (4, 128)
    assert list(t.blocks) == [8, 16, 32, 64, 128] == list(t.stages)
    assert t.blocks == {8: 3, 16: 2, 32: 2, 64: 2, 128: 1}
    assert t.stages == {8: 8, 16: 8, 32: 6, 64: 4, 128: 4}
    assert attention_source_tiles()[:2] == (128, 64)
    with pytest.raises(LookupError):
        build.source_ints("attention_tc.cuh", "NO_SUCH_CONSTANT")


def test_fake_cpu_tensors_take_the_plain_version():
    """Fake CPU tensors are no traced launch: the plain version runs (its
    ops traced), and no counter moves."""
    before = _counts()
    with FakeTensorMode():
        q = torch.zeros((4, 64, 64), dtype=F32)
        out = flash_attention_fwd(q, q, q)
    assert tuple(out.shape) == (4, 64, 64) and out.device.type == "cpu"
    assert _counts() == before
    assert not build.traced(q) and build.traced() is False


def test_real_tensors_are_not_traced():
    t = torch.zeros(3)
    assert not build.traced(t) and not build.on_card(t)
    assert build.address(t) == t.data_ptr()
    with FakeTensorMode():
        m = torch.zeros((4, 8), device="meta")[1:]
    assert build.traced(m) and build.on_card(m)
    assert build.address(m) == 8 * 4
