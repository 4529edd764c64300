"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA inputs, bit-exact (tolerance 0), a refused launch
that must raise, and the Carver's, BatchCarver's, the column-sharded
resize's (one device, and distinct devices: the card and the CPU) and the
fused seam step's CUDA paths against the C++ reference.

Marked ``cuda``; every test skips where CUDA is unavailable. On a machine
with an NVIDIA GPU (no jax needed, so skip tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

import lqr_tpu_torch
from lqr_tpu_torch import native
from lqr_tpu_torch.core import engine
from lqr_tpu_torch.core.state import EngineConfig, init_state
from lqr_tpu_torch import profiling
from lqr_tpu_torch.ops import _build, carve_resident, dp_cuda
from lqr_tpu_torch.ops.place_mask import place_mask

import mask_cases

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _load_script(rel: str):
    """A script of the repository (a path from its root) as a module."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_script("chip_smoke.py")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; CUDA is not available")
    return torch.device("cuda", 0)


def _case(seed, H, W, Wb, has_rig, device):
    rng = np.random.default_rng(seed)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * 8) / 8
    rig = None
    if has_rig:
        rig = np.zeros((H, Wb), np.float32)
        rig[:, :W] = np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4
        rig = torch.from_numpy(rig).to(device)
    return torch.from_numpy(e).to(device), rig


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 256, (h, w, 3)) // 64) * 64).astype(np.uint8)


@pytest.mark.parametrize("H,W,Wb,dx,has_rig", [
    (2048, 2048, 2048, 1, False),      # the main path's shape
    (256, 1000, 1024, 2, True),
    (300, 380, 384, 1, False),
    (40, 100, 128, 3, True),
    (16, 1, 128, 0, False),
])
def test_kernels_match_plain(cuda, H, W, Wb, dx, has_rig):
    e, rig = _case(H + dx, H, W, Wb, has_rig, cuda)
    for pref in (True, False):
        M_k, bp_k = dp_cuda.dp_forward(e, rig, pref, dx, has_rig)
        M_p, bp_p = dp_cuda.dp_forward_plain(e, rig, pref, dx, has_rig)
        seam_k = dp_cuda.backtrack(M_p, bp_p, pref)
        seam_p = dp_cuda.backtrack_plain(M_p, bp_p, pref)
        torch.cuda.synchronize()
        assert torch.equal(M_k, M_p) and torch.equal(bp_k, bp_p), pref
        assert torch.equal(seam_k, seam_p), pref


def test_refused_launch_raises(cuda):
    """A bad argument never launches: the wrapper refuses delta_x = 64, and
    so does the kernel's own launcher when called past the wrapper, as it
    refuses a strip geometry whose halo is narrower than delta_x * K or a
    cluster of more than 8 blocks."""
    from lqr_tpu_torch.ops import _build
    before = dict(dp_cuda.LAUNCHES)
    e = torch.zeros((2, 256), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="delta_x=64"):
        dp_cuda.dp_forward(e, None, True, 64, False)
    lib = _build.load()
    m = torch.empty(256, device=cuda)
    bp = torch.empty((2, 256), dtype=torch.int8, device=cuda)
    rigc = torch.zeros(65, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    geo = dp_cuda.strip_geometry(256, 1, 12)
    for dx, g in ((64, geo), (2, (1, 1, 160, 48, 25)), (1, (9, 1, 16, 120, 8))):
        rc = lib.lqr_dp_forward(e.data_ptr(), None, rigc.data_ptr(), 1, dx,
                                2, 256, 2, *g, m.data_ptr(), bp.data_ptr(),
                                None, stream)
        with pytest.raises(RuntimeError, match="lqr_dp_forward launch failed"):
            _build.check(lib, rc, "lqr_dp_forward")
    assert dp_cuda.LAUNCHES == before
    # the refused launch leaves no pending error behind
    torch.cuda.synchronize()
    assert torch.equal(torch.ones(3, device=cuda) * 2,
                       torch.full((3,), 2.0, device=cuda))


@pytest.mark.parametrize("H,W,Wb,dx,has_rig,energy", SMOKE.EDGE_CASES)
def test_strip_kernel_edges_match_plain(cuda, H, W, Wb, dx, has_rig,
                                        energy):
    """Tolerance 0 on M_last, bp at every column and the seam, at the shapes
    where the strips, halos, copy paths and chase windows meet their edges
    (chip_smoke.EDGE_CASES)."""
    e, rig = SMOKE._edge_case(H, W, Wb, dx, has_rig, energy, cuda)
    assert e.is_contiguous()
    for pref in (True, False):
        M_k, bp_k = dp_cuda.dp_forward(e, rig, pref, dx, has_rig)
        M_p, bp_p = dp_cuda.dp_forward_plain(e, rig, pref, dx, has_rig)
        seam_k = dp_cuda.backtrack(M_k, bp_k, pref)
        seam_p = dp_cuda.backtrack_plain(M_p, bp_p, pref)
        torch.cuda.synchronize()
        assert torch.equal(M_k, M_p) and torch.equal(bp_k, bp_p), pref
        assert torch.equal(seam_k, seam_p), pref


@pytest.mark.parametrize("dx,has_rig,h", [(1, False, None), (2, True, 30)])
def test_wide_dp_matches_plain(cuda, dx, has_rig, h):
    """Wb = 32768: two frontier rows exceed the shared memory, so the
    kernel keeps them in its global scratch (full height, and ragged)."""
    H, Wb = 48, 32768
    assert dp_cuda.frontier_scratch(Wb, cuda) is not None
    e, rig = _case(7 + dx, H, Wb - 5, Wb, has_rig, cuda)
    for pref in (True, False):
        M_k, bp_k = dp_cuda.dp_forward(e, rig, pref, dx, has_rig, h=h)
        M_p, bp_p = dp_cuda.dp_forward_plain(e, rig, pref, dx, has_rig, h=h)
        torch.cuda.synchronize()
        assert torch.equal(M_k, M_p) and torch.equal(bp_k, bp_p), pref


@pytest.mark.parametrize("h", [1, 17, 40])
def test_ragged_dp_matches_plain(cuda, h):
    """Rows >= h pass the frontier through with bp = 0; a per-image rigc."""
    from lqr_tpu_torch.parallel.batch import rigc_table
    e, rig = _case(h, 40, 200, 256, True, cuda)
    rigc = torch.from_numpy(rigc_table([h], 2)[0]).to(cuda)
    for pref in (True, False):
        got = dp_cuda.dp_forward(e, rig, pref, 2, True, h=h, rigc_vec=rigc)
        want = dp_cuda.dp_forward_plain(e, rig, pref, 2, True, h=h,
                                        rigc_vec=rigc)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("dx,has_rig", [(1, False), (1, True), (2, True)])
def test_dp_block_matches_plain(cuda, dx, has_rig, first):
    """The sharded DP block at the 2048^2 shard width on four shards:
    R = 32 rows over We = 512 + 2 * 32 * delta_x, +inf halo edges."""
    from lqr_tpu_torch.ops import dp_block
    R, G = 32, 32 * dx
    We = 512 + 2 * G
    e, rig = _case(dx * 10 + first, R, We - G, We, has_rig, cuda)
    m0 = e[-1].flip(0).contiguous()
    for pref in (True, False):
        before = dp_cuda.LAUNCHES["dp_block"]
        got = dp_block.dp_block(m0, e, rig, pref, first, dx, has_rig, 2048)
        want = dp_block.dp_block_plain(m0, e, rig, pref, first, dx, has_rig,
                                       2048)
        torch.cuda.synchronize()
        assert dp_cuda.LAUNCHES["dp_block"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("first,dx,has_rig", [(False, 1, False),
                                              (True, 2, True)])
def test_dp_block_wide_slab_matches_plain(cuda, first, dx, has_rig):
    """A slab whose two frontier rows exceed the shared memory (We = 30 001
    lanes) keeps them in a global scratch: bit-exact, one launch."""
    from lqr_tpu_torch.ops import dp_block
    R, We = 12, 30001
    assert 2 * We * 4 > dp_cuda.smem_optin(cuda)
    e, rig = _case(3 + dx, R, We - 7, We, has_rig, cuda)
    m0 = e[-1].flip(0).contiguous()
    for pref in (True, False):
        before = dp_cuda.LAUNCHES["dp_block"]
        got = dp_block.dp_block(m0, e, rig, pref, first, dx, has_rig, 2048)
        want = dp_block.dp_block_plain(m0, e, rig, pref, first, dx, has_rig,
                                       2048)
        torch.cuda.synchronize()
        assert dp_cuda.LAUNCHES["dp_block"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", SMOKE.SHARDED_EDGES)
def test_dp_sharded_edges_match_plain(cuda, case):
    """The one-launch column-sharded DP against the per-block loop with
    dp_block's plain version, tolerance 0, one counted launch each, and its
    own columns against dp_forward."""
    assert SMOKE.check_sharded_case(cuda, case, seed=len(case),
                                    own_vs_forward=True) == 0.0


def test_dp_sharded_refuses_a_bad_geometry(cuda):
    """The launcher refuses a window halo narrower than delta_x * K, a
    cluster of 9 blocks, R not dividing H and more warps than strips;
    nothing launches. The wrapper refuses 9 shards with LqrConfigError."""
    import ctypes
    from lqr_tpu_torch import LqrConfigError
    from lqr_tpu_torch.ops import dp_block
    lib = _build.load()
    e = torch.zeros((9, 32, 64), device=cuda)
    ptrs = (ctypes.c_void_p * 9)(*[e[c].data_ptr() for c in range(9)])
    m = torch.empty((9, 64), device=cuda)
    bp = torch.empty((9, 32, 64), dtype=torch.int8, device=cuda)
    rigc = torch.zeros(4, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    before = dict(dp_cuda.LAUNCHES)
    for n, R, dx, geo in ((2, 16, 3, (1, 16, 32, 192)),
                          (9, 16, 1, (1, 16, 16, 224)),
                          (2, 12, 1, (1, 12, 16, 224)),
                          (2, 16, 1, (2, 16, 16, 224))):
        rc = lib.lqr_dp_sharded(ptrs, None, rigc.data_ptr(), 1, dx, n, 32,
                                64, R, *geo, m.data_ptr(), bp.data_ptr(),
                                None, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(lib, rc, "lqr_dp_sharded")
    with pytest.raises(LqrConfigError, match="shards"):
        dp_block.dp_sharded(list(e), None, True, 1, False, 32, 16)
    torch.cuda.synchronize()
    assert dp_cuda.LAUNCHES == before


@pytest.mark.parametrize("case", SMOKE.RESIDENT_EDGES)
def test_resident_edges_match_plain(cuda, case):
    """Tolerance 0 on hist rows < kc and every plane at the resident
    kernel's edges (chip_smoke.RESIDENT_EDGES: Wb % 4 != 0, Wb < 32, H = 1,
    H - 1 not a multiple of K, delta_x 0, 3 and 10, ties, unaligned
    planes): the solo entry, and the batched entry with ragged heights."""
    assert SMOKE.check_resident_edges(cuda, [case]) == 0.0


def test_resident_phases_build_matches_plain(cuda):
    """tools/resident_phases.py's build (-DLQR_RESIDENT_PHASES) carves as the
    plain version does and times every phase of its seams; the library
    load() gives is back after _build.using."""
    phases = _load_script("tools/resident_phases.py")
    lib = phases.load_phases()
    case = (70, 640, 640, 12, 1, 0, True, "ties")
    H, Wb, w0, kc, dx, nrg, masks, _ = case
    b, bias, rig, pm = SMOKE.resident_edge(case, cuda)
    args = (b, bias, rig, pm, w0, 5, kc, dx, masks, masks, nrg, 1, engine.KC)
    default = _build.load()
    with _build.using(lib):
        assert _build.load() is lib
        ms, per = phases.measure(
            lib, lambda: carve_resident.carve_chunk_resident(*args), kc)
        got = carve_resident.carve_chunk_resident(*args)
    assert _build.load() is default
    want = carve_resident.carve_chunk_resident_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(per) == len(phases.PHASES) and min(per) >= 0 and per[1] > 0
    assert sum(per) <= 1.25 * 1e3 * ms / kc


def _fewest_maps_on(cluster, Wp, dx, has_rig, device):
    """The fewest maps (2 to 1024) for which the batched entry puts each
    map on `cluster` (blocks, warps a block) on this card, or None."""
    clusters = functools.partial(carve_resident.resident_clusters, device,
                                 Wp, dx, has_rig)
    return next((B for B in range(2, 1025)
                 if carve_resident.batch_cluster(B, clusters) == cluster),
                None)


@pytest.mark.parametrize("cluster", [*carve_resident.BATCH_CLUSTERS,
                                     carve_resident.ONE_BLOCK])
def test_resident_batched_matches_plain(cuda, cluster):
    """A ragged batch with bias and rigidity in one launch: per-map w0, d0,
    kc (0 for every fourth map) and true height (1 for every fourth), as
    many maps as make the entry put each on `cluster` on this card
    (ONE_BLOCK: more than the card holds at once of every wider cluster);
    BATCH_BLOCKS records its blocks a map."""
    from lqr_tpu_torch.parallel.batch import rigc_table
    H, W, Wb, dx = 40, 250, 256, 2
    B = _fewest_maps_on(cluster, Wb, dx, True, cuda)
    if B is None:
        pytest.skip(f"the batched entry puts no batch on {cluster} for "
                    f"{Wb} columns on this card")
    maps = [_resident_planes(20 + i, H, W, Wb, cuda) for i in range(B)]
    b, bias, rig, pm = (torch.stack(p) for p in zip(*maps))
    # the first four maps as ever; the rest cycle them with fewer seams
    heights = [(40, 31, 12, 1)[i % 4] for i in range(B)]
    for i, h in enumerate(heights):
        for plane in (b, bias, rig):
            plane[i, h:] = 0
    w0 = [(241, 250, 200, 230)[i % 4] for i in range(B)]
    d0 = [(9, 0, 50, 20)[i % 4] for i in range(B)]
    kc = [(23, 30, 0, 7)[i % 4] // (1 if i < 4 else 6) for i in range(B)]
    rigc = torch.from_numpy(rigc_table(heights, dx)).to(cuda)
    for nrg in (0, 1):
        args = (b, bias, rig, pm, w0, d0, kc, heights, rigc, dx, True, True,
                nrg, 2, engine.KC)
        before = dp_cuda.LAUNCHES["carve_resident"]
        blocks = dict(carve_resident.BATCH_BLOCKS)
        got = carve_resident.carve_chunk_resident_batched(*args)
        params = carve_resident._batched_params(B, H, Wb, w0, d0, kc,
                                                heights, engine.KC)
        want = carve_resident.carve_chunk_resident_batched_plain(
            b, bias, rig, pm, params, rigc, dx, True, True, nrg, 2,
            engine.KC)
        torch.cuda.synchronize()
        assert dp_cuda.LAUNCHES["carve_resident"] == before + 1
        assert {k: v - blocks[k] for k, v in
                carve_resident.BATCH_BLOCKS.items()} == {
            k: int(k == str(cluster[0])) for k in blocks}
        for g, e in zip(got, want):
            assert torch.equal(g, e), nrg


def test_wide_carver_cuda_matches_native(cuda):
    """A map wider than the DP kernel's shared-memory frontier carves on
    the card through the per-seam kernels."""
    img = _image(5, 16, 32700)
    c = lqr_tpu_torch.Carver(img, device="cuda")
    before = dict(dp_cuda.LAUNCHES)
    c.resize(32697, 16)
    assert dp_cuda.LAUNCHES["dp_forward"] == before["dp_forward"] + 3
    vs = native.carve(img, 3)
    np.testing.assert_array_equal(c.vmap_dump().data, vs)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, 32697))


def test_batch_carver_cuda_matches_native(cuda, monkeypatch):
    """A ragged BatchCarver with biases, rigmasks and an aux image on the
    batched resident kernel, against the C++ reference per image; the
    per-seam route gives the same state."""
    from lqr_tpu_torch.parallel import BatchCarver
    from lqr_tpu_torch.parallel import batch as tb
    rng = np.random.default_rng(8)
    sizes = [(40, 150), (64, 200), (25, 90), (64, 120)]
    imgs = [_image(30 + i, h, w) for i, (h, w) in enumerate(sizes)]
    biases = [np.round(rng.standard_normal((h, w)) * 4).astype(np.float32)
              / 8 for h, w in sizes]
    rigm = [np.abs(rng.standard_normal((h, w))).astype(np.float32)
            for h, w in sizes]
    aux = [[rng.integers(0, 256, (h, w, 4)).astype(np.uint8)]
           for h, w in sizes]
    n = np.array([20, 31, 9, 0])
    bc = BatchCarver(imgs, rigidity=20.0, biases=biases, rigmasks=rigm,
                     aux=aux, device="cuda")
    before = dp_cuda.LAUNCHES["carve_resident"]
    bc.carve(n)
    assert dp_cuda.LAUNCHES["carve_resident"] == before + 1
    vs = bc.state.vs.cpu().numpy()
    outs = bc.images_at(bc.widths - n)
    auxs = bc.aux_at(bc.widths - n)
    for i, ((h, w), im) in enumerate(zip(sizes, imgs)):
        ref = native.carve(im, int(n[i]), bias=biases[i],
                           rig=rigm[i] * np.float32(20.0))
        np.testing.assert_array_equal(vs[i, :h, :w], ref)
        np.testing.assert_array_equal(outs[i],
                                      native.materialize(im, ref, w - n[i]))
        np.testing.assert_array_equal(
            auxs[i][0], native.materialize(aux[i][0], ref, w - n[i]))
    st0 = BatchCarver(imgs, rigidity=20.0, biases=biases, rigmasks=rigm,
                      device="cuda")
    monkeypatch.setattr(tb, "resident_ok", lambda *a: False)
    per_seam = tb.extend_batched(st0.cfg, st0.state, n, st0.heights)
    assert torch.equal(per_seam.vs, bc.state.vs)
    assert torch.equal(per_seam.cur_b, bc.state.cur_b)


def test_column_sharded_cuda_matches_native(cuda):
    """Four column shards on one card: one dp_sharded launch a seam (no
    dp_block launch), the seams equal to the C++ reference's."""
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh
    img = _image(9, 64, 512)
    mesh = make_mesh(devices=[cuda] * 4, data=1)
    bc = BatchCarver([img], mesh=mesh)
    assert bc.col_sharded
    before = dict(dp_cuda.LAUNCHES)
    bc.carve(8)
    assert dp_cuda.LAUNCHES["dp_sharded"] == before["dp_sharded"] + 8
    assert dp_cuda.LAUNCHES["dp_block"] == before["dp_block"]
    assert dp_cuda.LAUNCHES["backtrack"] == before["backtrack"] + 8
    assert dp_cuda.LAUNCHES["dp_forward"] == before["dp_forward"]
    vs = native.carve(img, 8)
    np.testing.assert_array_equal(bc.state.vs[0].cpu().numpy(), vs)
    np.testing.assert_array_equal(bc.images_at(504)[0],
                                  native.materialize(img, vs, 504))


def test_column_sharded_wide_cuda_matches_native(cuda):
    """Two column shards of 30 016 columns on one card: slabs whose
    frontier rows do not fit the shared memory, so dp_sharded keeps them in
    device scratch and each warp runs several strips; one launch a seam,
    the seams equal to the C++ reference's."""
    from lqr_tpu_torch.ops import dp_block
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh
    img = _image(11, 32, 60000)
    bc = BatchCarver([img], mesh=make_mesh(devices=[cuda] * 2, data=1))
    Wl = bc.state.vs.shape[-1] // 2
    assert dp_block.sharded_geometry(Wl, 1, 32, False,
                                     dp_cuda.smem_optin(cuda))[4]
    before = dict(dp_cuda.LAUNCHES)
    bc.carve(3)
    assert dp_cuda.LAUNCHES["dp_sharded"] == before["dp_sharded"] + 3
    assert dp_cuda.LAUNCHES["dp_block"] == before["dp_block"]
    vs = native.carve(img, 3)
    np.testing.assert_array_equal(bc.state.vs[0, :, :60000].cpu().numpy(),
                                  vs)
    np.testing.assert_array_equal(bc.images_at(59997)[0],
                                  native.materialize(img, vs, 59997))


def test_column_sharded_distinct_devices_matches_native(cuda):
    """Two column shards on distinct devices, the card and the CPU: the
    per-block loop, dp_block on the card's shard (R = 32 rows: 2 blocks a
    seam), the halos copied between the two; the seams equal to the C++
    reference's."""
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh
    img = _image(10, 64, 256)
    bc = BatchCarver([img], mesh=make_mesh(devices=[cuda, "cpu"], data=1))
    before = dict(dp_cuda.LAUNCHES)
    bc.carve(6)
    assert dp_cuda.LAUNCHES["dp_block"] == before["dp_block"] + 6 * 2
    assert dp_cuda.LAUNCHES["dp_sharded"] == before["dp_sharded"]
    vs = native.carve(img, 6)
    np.testing.assert_array_equal(bc.state.vs[0].cpu().numpy(), vs)
    np.testing.assert_array_equal(bc.images_at(250)[0],
                                  native.materialize(img, vs, 250))


def test_carver_cuda_matches_native(cuda):
    img = _image(1, 192, 256)
    before = dict(dp_cuda.LAUNCHES)
    c = lqr_tpu_torch.Carver(img, device="cuda")
    c.resize(230, 192)
    vs = native.carve(img, 26)
    np.testing.assert_array_equal(c.vmap_dump().data, vs)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, 230))
    # 192 x 256 takes the resident route: one launch for the 26 seams
    launched = {k: dp_cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"dp_forward": 0, "backtrack": 0, "carve_resident": 1,
                        "dp_block": 0, "dp_sharded": 0,
                        "dp_energy_forward": 0, "backtrack_compact": 0}
    c.resize(270, 192)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, 270))


def _resident_planes(seed, H, W, Wb, device):
    """A reader plane of few levels (ties on purpose), a bias of eighths,
    a rigidity field and the identity posmap, zero past W."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((3, H, Wb), np.float32)
    planes[0, :, :W] = rng.integers(0, 6, (H, W)) / np.float32(5)
    planes[1, :, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    planes[2, :, :W] = np.abs(np.round(rng.standard_normal((H, W)) * 8))
    pm = np.zeros((H, Wb), np.int32)
    pm[:, :W] = np.arange(W)
    b, bias, rig = torch.from_numpy(planes).to(device)
    return b, bias, rig, torch.from_numpy(pm).to(device)


@pytest.mark.parametrize("dx", [1, 2])
@pytest.mark.parametrize("nrg", range(7))
def test_resident_kernel_matches_plain(cuda, nrg, dx):
    """A partial chunk (kc < KC) at depth d0 > 0, bias and rig on and off;
    tolerance 0 on hist rows < kc and on every plane at every column."""
    H, W, Wb, w0, d0, kc = 40, 250, 256, 241, 9, 23
    b, bias, rig, pm = _resident_planes(nrg * 10 + dx, H, W, Wb, cuda)
    for has_bias in (False, True):
        for has_rig in (False, True):
            args = (b, bias if has_bias else None, rig if has_rig else None,
                    pm, w0, d0, kc, dx, has_bias, has_rig, nrg, 2,
                    engine.KC)
            before = dp_cuda.LAUNCHES["carve_resident"]
            got = carve_resident.carve_chunk_resident(*args)
            want = carve_resident.carve_chunk_resident_plain(*args)
            torch.cuda.synchronize()
            assert dp_cuda.LAUNCHES["carve_resident"] == before + 1
            assert torch.equal(got[0], want[0]), (has_bias, has_rig)
            assert (got[0][kc:] == -1).all()
            for g, e in zip(got[1:], want[1:]):
                assert (g is None) == (e is None)
                if g is not None:
                    assert torch.equal(g, e), (has_bias, has_rig)


def test_masked_carver_cuda_matches_native(cuda):
    """bias_add (preservation and discard), rigmask_add and attach through
    the resident kernel, against the C++ reference."""
    from lqr_tpu_torch.carver import place_mask_numpy
    h, w, n, rigidity = 96, 160, 40, 50.0
    img = _image(3, h, w)
    rng = np.random.default_rng(4)
    pres = rng.integers(0, 256, (h // 4, w // 4, 3)).astype(np.uint8)
    disc = rng.integers(0, 256, (h // 2, w // 2, 1)).astype(np.uint8)
    rigm = rng.integers(0, 256, (h, w // 3)).astype(np.uint8)
    aux = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    before = dict(dp_cuda.LAUNCHES)
    c = lqr_tpu_torch.Carver(img, rigidity=rigidity, device="cuda")
    c.bias_add(pres, 1000.0, w // 4, h // 4)
    c.bias_add(disc, -800.0, w // 2, h // 2)
    c.rigmask_add(rigm)
    c.attach(aux)
    c.resize(w - n, h)
    B = (place_mask_numpy(pres, h, w, w // 4, h // 4) * np.float32(1.0)
         + place_mask_numpy(disc, h, w, w // 2, h // 2) * np.float32(-0.8))
    R = place_mask_numpy(rigm, h, w, 0, 0) * np.float32(rigidity)
    vs = native.carve(img, n, bias=B, rig=R)
    np.testing.assert_array_equal(c.vmap_dump().data, vs)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, w - n))
    np.testing.assert_array_equal(c.get_aux(0),
                                  native.materialize(aux, vs, w - n))
    assert dp_cuda.LAUNCHES["carve_resident"] == before["carve_resident"] + 1
    assert dp_cuda.LAUNCHES["dp_forward"] == before["dp_forward"]


def _same_bits(a, b):
    """Bit-equal f32 tensors (the signs of zero count)."""
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_place_mask_matches_plain(cuda, C, n):
    """ops.place_mask (plain PyTorch) on the card against the same on the
    CPU, n placements summed into one plane (mask_cases.mask_runs: offsets
    inside, negative, past the edges, outside, a mask larger than the
    plane; factors +-1000, -800)."""
    H, W = mask_cases.MASK_PLANE
    for run in mask_cases.mask_runs(C, n):
        got = cpu = None
        for mask, x_off, y_off, factor in run:
            f = np.float32(factor / 1000.0)
            m = torch.from_numpy(mask)
            got = place_mask(m.to(cuda), H, W, x_off, y_off, f, got)
            cpu = place_mask(m, H, W, x_off, y_off, f, cpu)
        torch.cuda.synchronize()
        assert got.is_cuda and _same_bits(got, cpu), run


@pytest.mark.parametrize("hw,count", [((2048, 2048), 2), ((768, 1024), 3)])
def test_place_mask_at_the_cells_shapes(cuda, hw, count):
    """The masked cells' shapes: image-sized one-channel masks at +1000,
    -1000 and a rigidity mask, summed on the card and on the CPU."""
    got = cpu = None
    for mask, factor in mask_cases.cell_masks(hw, count):
        f = np.float32(1.0 if factor is None else factor / 1000.0)
        m = torch.from_numpy(mask)
        got = place_mask(m.to(cuda), *hw, 0, 0, f, got)
        cpu = place_mask(m, *hw, 0, 0, f, cpu)
    torch.cuda.synchronize()
    assert _same_bits(got, cpu)


def test_masked_carver_planes_cuda_match_cpu(cuda):
    """A CUDA Carver's bias and rigidity planes after bias_add and
    rigmask_add (1-4 channels, clipped offsets, a flatten of a vertical
    map between placements) equal a CPU Carver's bit for bit, and
    bytes.h2d counts the masks' u8 bytes."""
    h, w = 96, 160
    img = _image(5, h, w)
    rng = np.random.default_rng(6)
    masks = [(rng.integers(0, 256, (h // 2, w // 3, c)).astype(np.uint8),
              x_off, y_off, factor)
             for c, x_off, y_off, factor in ((3, w // 4, h // 4, 1000.0),
                                             (4, -20, -10, -800.0),
                                             (1, w - 30, h - 20, None),
                                             (2, 0, 0, -1000.0))]
    carvers = {dev: lqr_tpu_torch.Carver(img, rigidity=30.0, device=dev)
               for dev in ("cpu", cuda)}
    for dev, c in carvers.items():
        before = profiling.counters()["bytes.h2d"]
        for j, (mask, x_off, y_off, factor) in enumerate(masks):
            if factor is None:
                c.rigmask_add(mask, x_off, y_off)
            else:
                c.bias_add(mask, factor, x_off, y_off)
            if j == 1:
                c.resize(w, h - 8)      # a vertical map, then a flatten
        uploaded = profiling.counters()["bytes.h2d"] - before
        assert uploaded == sum(m.nbytes for m, *_ in masks), dev
    cpu, gpu = carvers["cpu"], carvers[cuda]
    assert gpu._ref_bias.is_cuda and gpu._ref_rig.is_cuda
    assert _same_bits(gpu._ref_bias, cpu._ref_bias)
    assert _same_bits(gpu._ref_rig, cpu._ref_rig)


@pytest.mark.parametrize("nrg,dx,rig", [(2, 2, 0.0), (4, 1, 25.0)])
def test_extend_map_cuda_matches_cpu(cuda, monkeypatch, nrg, dx, rig):
    img = _image(2, 64, 200)
    cfg = EngineConfig(H=64, Wb=256, C=3, delta_x=dx, nrg=nrg,
                       has_rig=rig > 0)
    field = np.full((64, 200), np.float32(rig)) if rig else None
    cpu = engine.extend_map(cfg, init_state(cfg, img, rig=field,
                                              device="cpu"), 30)
    # both routes on the card: the per-seam kernels and the resident one
    for route in ("per_seam", "resident"):
        monkeypatch.setattr(engine, "route", lambda cfg, r=route: r)
        got = engine.extend_map(cfg, init_state(cfg, img, rig=field,
                                                device=cuda), 30)
        for name in ("vs", "cur_b"):
            np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                          getattr(cpu, name).numpy())
        for w in (170, 230):
            np.testing.assert_array_equal(
                engine.materialize(cfg, got, w, 256).cpu().numpy(),
                engine.materialize(cfg, cpu, w, 256).numpy())


def _step_planes(seed, H, W, Wb, device):
    """Reader plane of few levels (ties on purpose), a bias of eighths and a
    rigidity field, zero past W."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((3, H, Wb), np.float32)
    planes[0, :, :W] = rng.integers(0, 6, (H, W)) / np.float32(5)
    planes[1, :, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    planes[2, :, :W] = np.abs(np.round(rng.standard_normal((H, W)) * 8))
    return tuple(torch.from_numpy(planes).to(device))


_STEP_SHAPES = [
    # H, W, Wb, w, delta_x, nrg, has_bias, has_rig
    (2048, 2048, 2048, 2048, 1, 0, False, False),   # the main path's shape
    (2048, 2048, 2048, 1990, 2, 0, True, True),
    (256, 1000, 1024, 980, 2, 2, True, True),
    (40, 250, 256, 231, 1, 6, True, True),
    (64, 300, 384, 300, 3, 1, False, True),
    (16, 1, 128, 1, 0, 4, False, False),
] + [case[:8] for case in SMOKE.STEP_EDGES if case[8] == "ties"]


# dp_energy_forward's cases: the strip kernel's edges (chip_smoke.EDGE_CASES,
# "offset": the planes 4 bytes past a 16-byte boundary, so the producers
# copy with cp.async instead of tensor copies) under every energy, without
# and with bias and rigidity; widths past one block's shared-memory
# frontier; the step shapes above
_DEF_CASES = (
    [(H, W, Wb, max(1, W - nrg % 3), dx, nrg, m, m, planes)
     for H, W, Wb, dx, _, planes in SMOKE.EDGE_CASES
     for nrg in range(7) for m in (False, True)]
    + [(256, 32768, 32768, 32760, 1, 0, False, True, "ties"),
       (8, 65536, 65536, 65436, 2, 2, True, True, "ties"),
       (8, 65536, 65536, 65536, 1, 0, False, False, "ties")]
    + [shape + ("ties",) for shape in _STEP_SHAPES])


@pytest.mark.parametrize("H,W,Wb,w,dx,nrg,has_bias,has_rig,planes",
                         _DEF_CASES)
def test_dp_energy_forward_matches_plain(cuda, H, W, Wb, w, dx, nrg,
                                         has_bias, has_rig, planes):
    from lqr_tpu_torch.ops import carve_step
    b, bias, rig = _step_planes(H + nrg, H, W, Wb, cuda)
    if planes == "offset":
        def offset(a):
            buf = torch.empty(a.numel() + 1, device=cuda)
            buf[1:] = a.flatten()
            return buf[1:].view(a.shape)
        b, bias, rig = offset(b), offset(bias), offset(rig)
    for pref in (True, False):
        args = (b, bias if has_bias else None, rig if has_rig else None, w,
                pref, dx, has_bias, has_rig, nrg)
        before = dp_cuda.LAUNCHES["dp_energy_forward"]
        M_k, bp_k = carve_step.dp_energy_forward(*args)
        M_p, bp_p = carve_step.dp_energy_forward_plain(*args)
        torch.cuda.synchronize()
        assert dp_cuda.LAUNCHES["dp_energy_forward"] == before + 1
        assert torch.equal(M_k, M_p) and torch.equal(bp_k, bp_p), pref


def test_sqrt_rn_matches_fsqrt_rn(cuda):
    """The producers' square root equals __fsqrt_rn in every bit at each of
    the 2^31 f32 values >= +0."""
    from lqr_tpu_torch.ops import carve_step
    assert carve_step.sqrt_rn_mismatches(cuda) == 0


# backtrack_compact's cases: the step shapes (with chip_smoke.STEP_EDGES'
# shapes), and STEP_EDGES' maps of one level (ties everywhere) and planes 4
# bytes past a 16-byte boundary (the scalar compaction)
_BTC_CASES = ([shape + ("ties",) for shape in _STEP_SHAPES]
              + [case for case in SMOKE.STEP_EDGES if case[8] != "ties"])


@pytest.mark.parametrize("H,W,Wb,w,dx,nrg,has_bias,has_rig,kind",
                         _BTC_CASES)
def test_backtrack_compact_matches_plain(cuda, H, W, Wb, w, dx, nrg,
                                         has_bias, has_rig, kind):
    from lqr_tpu_torch.ops import carve_step
    if kind == "ties":
        b, bias, rig = _step_planes(H + dx, H, W, Wb, cuda)
    else:
        b, bias, rig = SMOKE.step_planes(
            (H, W, Wb, w, dx, nrg, has_bias, has_rig, kind), cuda)
    planes = (b, bias if has_bias else None, rig if has_rig else None)
    for pref in (True, False):
        M, bp = carve_step.dp_energy_forward_plain(*planes, w, pref, dx,
                                                   has_bias, has_rig, nrg)
        before = dp_cuda.LAUNCHES["backtrack_compact"]
        got = carve_step.backtrack_compact(M, bp, *planes, w, pref, has_bias,
                                           has_rig)
        want = carve_step.backtrack_compact_plain(M, bp, *planes, w, pref,
                                                  has_bias, has_rig)
        torch.cuda.synchronize()
        assert dp_cuda.LAUNCHES["backtrack_compact"] == before + 1
        assert torch.equal(got[0], want[0]), pref
        for g, e, p in zip(got[1:], want[1:], planes):
            if p is None:
                assert g is None and e is None      # an absent plane
            else:
                assert torch.equal(g, e) and g is not p, pref


def _chase_maps(seed, H, Wb, w, device):
    """An M_last of few levels (ties on purpose, +inf at x >= w) and a bp
    of steps in {-1, 0, 1} that keeps every path inside [0, w), as a
    delta_x = 1 DP gives them."""
    rng = np.random.default_rng(seed)
    M = np.full(Wb, np.inf, np.float32)
    M[:w] = rng.integers(0, 4, w)
    bp = rng.integers(-1, 2, (H, Wb)).astype(np.int8)
    bp[:, 0] = np.maximum(bp[:, 0], 0)
    bp[:, w - 1] = np.minimum(bp[:, w - 1], 0)
    return torch.from_numpy(M).to(device), torch.from_numpy(bp).to(device)


def test_backtrack_compact_back_to_back_launches(cuda):
    """50 launches on one stream, none waiting for another, each on its
    own M_last and bp but all at the same output pointers and on the same
    ticket and progress words: each equals its plain version, so no launch
    read an earlier launch's progress (it would compact along that launch's
    seam)."""
    from lqr_tpu_torch.ops import carve_step
    lib = _build.load()
    H, Wb = 1024, 2048
    b, bias, rig = _step_planes(50, H, Wb, Wb, cuda)
    maps = [_chase_maps(k, H, Wb, Wb - k % 7, cuda) for k in range(50)]
    seam = torch.empty(H, dtype=torch.int32, device=cuda)
    outs = [torch.empty_like(b) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream
    got = []
    torch.cuda.synchronize()
    for k, (M, bp) in enumerate(maps):
        masks = k % 3 != 0
        sync, epoch = carve_step._sync_words(cuda, stream)
        rc = lib.lqr_backtrack_compact(
            M.data_ptr(), bp.data_ptr(), b.data_ptr(),
            bias.data_ptr() if masks else None,
            rig.data_ptr() if masks else None, k % 2, H, Wb, Wb - k % 7,
            seam.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if masks else None,
            outs[2].data_ptr() if masks else None, sync.data_ptr(), epoch,
            stream)
        _build.check(lib, rc, "lqr_backtrack_compact")
        got.append([seam.clone()] + [o.clone() for o in outs[:1 + 2 * masks]])
    torch.cuda.synchronize()
    for k, (M, bp) in enumerate(maps):
        masks = k % 3 != 0
        want = carve_step.backtrack_compact_plain(
            M, bp, b, bias, rig, Wb - k % 7, k % 2 == 1, masks, masks)
        for g, e in zip(got[k], want):
            assert torch.equal(g, e), k


def test_backtrack_compact_two_streams(cuda):
    """Two streams launching at once, each on its own map (and its own
    ticket and progress words), 20 launches each interleaved: every result
    equals its plain version."""
    from lqr_tpu_torch.ops import carve_step
    shapes = ((2048, 2048, True), (777, 3000, False))
    inputs = []
    for i, (H, Wb, masks) in enumerate(shapes):
        planes = _step_planes(60 + i, H, Wb, Wb, cuda)
        inputs.append((planes, [_chase_maps(100 * i + k, H, Wb, Wb - k, cuda)
                                for k in range(20)], masks))
    streams = [torch.cuda.Stream(cuda) for _ in shapes]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for k in range(20):
        for i, st in enumerate(streams):
            (b, bias, rig), maps, masks = inputs[i]
            M, bp = maps[k]
            with torch.cuda.stream(st):
                out = carve_step.backtrack_compact(
                    M, bp, b, bias if masks else None,
                    rig if masks else None, b.shape[1] - k, k % 2 == 0,
                    masks, masks)
                got[i].append([o.clone() for o in out if o is not None])
    torch.cuda.synchronize()
    for i, ((b, bias, rig), maps, masks) in enumerate(inputs):
        for k, (M, bp) in enumerate(maps):
            want = carve_step.backtrack_compact_plain(
                M, bp, b, bias, rig, b.shape[1] - k, k % 2 == 0, masks,
                masks)
            for g, e in zip(got[i][k], [x for x in want if x is not None]):
                assert torch.equal(g, e), (i, k)


def test_carve_step_at_max_width(cuda):
    """Maps past one block's shared-memory frontier, up to the widest a
    test runs (8 x 65536 with bias and rigidity, 256 x 32768): both modes
    equal the plain step."""
    from lqr_tpu_torch.ops import carve_step
    for H, Wb, w, masks in ((8, 65536, 65536 - 3, True),
                            (256, 32768, 32768, False)):
        assert carve_step.fused_ok(H, Wb)
        b, bias, rig = _step_planes(4, H, w, Wb, cuda)
        args = (b, bias if masks else None, rig if masks else None, w, True,
                1, masks, masks, 0)
        want = carve_step.carve_step_plain(*args)
        for fuse in (False, True):
            got = carve_step.carve_step(*args, fuse_energy=fuse)
            torch.cuda.synchronize()
            for g, e in zip(got, want):
                assert (g is None and e is None) or torch.equal(g, e), fuse


def test_carve_step_refused_launches_raise(cuda):
    """Bad arguments never launch: the wrapper refuses delta_x = 11 (past
    fused_ok), and the launchers refuse delta_x = 11, more consumer warps
    than a block pairs, a halo narrower than delta_x * K, and a plane
    without its output, no ticket and progress words or an epoch of 0,
    when called past the wrapper."""
    from lqr_tpu_torch.ops import _build, carve_step
    lib = _build.load()
    before = dict(dp_cuda.LAUNCHES)
    b = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError, match="fused_ok"):
        carve_step.carve_step(b, None, None, 10, True, 11, False, False, 0,
                              fuse_energy=True)
    stream = torch.cuda.current_stream().cuda_stream
    m = torch.empty(256, device=cuda)
    bp = torch.empty((2, 256), dtype=torch.int8, device=cuda)
    rigc = torch.zeros(12, device=cuda)
    for dx, geo in ((11, dp_cuda.strip_geometry(256, 1)),
                    (1, (1, 9, 16, 120, 64)),
                    (2, (1, 1, 160, 48, 25))):
        rc = lib.lqr_dp_energy_forward(b.data_ptr(), None, None,
                                       rigc.data_ptr(), 1, dx, 0, 2, 256, 256,
                                       *geo, m.data_ptr(), bp.data_ptr(),
                                       None, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(lib, rc, "lqr_dp_energy_forward")
    seam = torch.empty(2, dtype=torch.int32, device=cuda)
    sync = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = torch.empty_like(b)
    # a plane without its output; no scratch words; epoch 0
    for bias, bias_out, words, epoch in ((b, None, sync, 1),
                                         (None, None, None, 1),
                                         (None, None, sync, 0)):
        rc = lib.lqr_backtrack_compact(
            m.data_ptr(), bp.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), None, 1, 2, 256, 256,
            seam.data_ptr(), out.data_ptr(), bias_out, None,
            None if words is None else words.data_ptr(), epoch, stream)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check(lib, rc, "lqr_backtrack_compact")
    assert dp_cuda.LAUNCHES == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("fuse", [False, True])
def test_carve_step_loop_cuda_matches_native(cuda, fuse):
    """chip_smoke.py's carve_step loop on the card, 150 seams of a 96 x 300
    image with bias and rigidity (a 128-seam commit and a partial one),
    against the C++ reference; two kernel launches per seam."""
    rng = np.random.default_rng(12)
    h, w, k = 96, 300, 150
    img = _image(6, h, w)
    bias = np.round(rng.standard_normal((h, w)) * 4).astype(np.float32) / 8
    rig = np.abs(rng.standard_normal((h, w))).astype(np.float32)
    cfg = EngineConfig(H=h, Wb=384, C=3, delta_x=2, has_bias=True,
                       has_rig=True)
    st = init_state(cfg, img, bias=bias, rig=rig, device=cuda)
    before = dict(dp_cuda.LAUNCHES)
    got = SMOKE.carve_step_loop(cfg, st, k, fuse)
    torch.cuda.synchronize()
    launched = {n: dp_cuda.LAUNCHES[n] - before[n] for n in before}
    fwd = "dp_energy_forward" if fuse else "dp_forward"
    assert launched == {n: k if n in (fwd, "backtrack_compact") else 0
                        for n in before}
    vs = native.carve(img, k, bias=bias, rig=rig, delta_x=2)
    np.testing.assert_array_equal(got.vs.cpu().numpy()[:, :w], vs)
    np.testing.assert_array_equal(
        engine.materialize(cfg, got, w - k, 384).cpu().numpy()[:, :w - k],
        native.materialize(img, vs, w - k))


@pytest.mark.parametrize("masks", [False, True])
def test_cli_on_the_card_matches_cpu(cuda, tmp_path, masks):
    """The command line file to file on the card: byte-equal to --cpu, and
    the carve went through a kernel (the resident one without masks at this
    size, and with them: the gate admits 96 x 160 either way)."""
    from lqr_tpu_torch import cli
    from lqr_tpu_torch.utils.image_io import save_image
    img = SMOKE.crop_image((96, 160))
    save_image(str(tmp_path / "in.png"), img)
    args = [str(tmp_path / "in.png"), "130", "90", "--seams",
            "--output-target", "new-layer"]
    if masks:
        save_image(str(tmp_path / "m.png"), img[20:60, 30:90])
        args += ["--pres", str(tmp_path / "m.png"), "--pres-offset", "30,20",
                 "--rigmask", str(tmp_path / "m.png"), "--rigidity", "50"]
    assert cli.main(args + ["-o", str(tmp_path / "cpu.png"), "--cpu"]) == 0
    SMOKE.reset_launches()
    assert cli.main(args + ["-o", str(tmp_path / "gpu.png")]) == 0
    assert dp_cuda.LAUNCHES["carve_resident"] == 2       # one an axis
    assert ((tmp_path / "gpu.png").read_bytes()
            == (tmp_path / "cpu.png").read_bytes())


def test_interactive_session_on_the_card_matches_cpu(cuda):
    """An interactive session on the card equals one on the CPU after every
    step (shrink, a lookup, map growth, enlargement, reset, a vertical map,
    a dump); lookups inside the map launch no kernel."""
    from lqr_tpu_torch.image_model import Image
    from lqr_tpu_torch.interactive import InteractiveSession
    img = SMOKE.crop_image((96, 160))
    ss = {dev: InteractiveSession(Image.from_array(img), device=dev)
          for dev in (cuda, "cpu")}
    steps = [(lambda s: s.set_size(130, 96), True),
             (lambda s: s.set_size(150, 96), False),
             (lambda s: s.set_size(120, 96), True),
             (lambda s: s.set_size(190, 96), False),
             (lambda s: s.reset_size(), False),
             (lambda s: s.reset_map(), False),
             (lambda s: s.set_size(160, 80), True),
             (lambda s: s.dump_seam_map(), False)]
    for j, (step, launches) in enumerate(steps):
        step(ss["cpu"])
        SMOKE.reset_launches()
        step(ss[cuda])
        torch.cuda.synchronize()
        assert (sum(dp_cuda.LAUNCHES.values()) > 0) == launches, j
        got, want = ss[cuda].image, ss["cpu"].image
        assert [l.name for l in got.layers] == [l.name for l in want.layers]
        for lg, lw in zip(got.layers, want.layers):
            np.testing.assert_array_equal(lg.pixels, lw.pixels,
                                          err_msg=f"step {j} {lg.name}")
        assert ss[cuda].map_info() == ss["cpu"].map_info(), j


_MAILBOX_WORKER = """
import datetime, json, os, sys, torch, torch.distributed as dist
from lqr_tpu_torch.parallel.mailbox import Mailbox
rank, init, n, mode = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), \\
    sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=10))
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
box = Mailbox(dist.group.WORLD, dev, 10.0, ("dp",), slots=2)
shape = (33, 32)                  # a halo plane of R = 32 rows (2048^2)
box.reserve({"dp": 33 * 32 * 4})
stream = (torch.cuda.Stream(dev) if mode == "stream" and rank == 0
          else torch.cuda.current_stream(dev))
bad = 0
with torch.cuda.stream(stream):
    base = torch.arange(33 * 32, dtype=torch.float32,
                        device=dev).view(shape)
    if rank == 1:
        for q in range(n):        # one way: the receiver lags behind
            if mode == "die" and q == n // 2:
                torch.cuda.synchronize()
                os._exit(7)
            box.send("dp", 0, base + q)
        echoes = []
        for q in range(n):        # round trips: each message sent back
            box.send("dp", 0, base - q)
            echoes.append(box.recv("dp", 0, shape, torch.float32).clone())
        box.settle()
        bad = sum(not torch.equal(e, base - q) for q, e in enumerate(echoes))
    else:
        got = []
        for q in range(n):
            got.append(box.recv("dp", 1, shape, torch.float32).clone())
            if mode == "die" and q % 8 == 7:
                box.settle()      # a seam step's end: a deadline
        box.settle()
        bad = sum(not torch.equal(g, base + q) for q, g in enumerate(got))
        for q in range(n):
            box.send("dp", 1, box.recv("dp", 1, shape, torch.float32))
        box.settle()
print(json.dumps({"rank": rank, "bad": bad}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _mailbox_workers(tmp_path, n: int, mode: str, timeout: float = 120):
    """Two processes on the card trading n messages through a 2-slot
    mailbox ring (_MAILBOX_WORKER): each one's (return code, stdout,
    stderr), every process killed at the timeout."""
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    _build.load()               # built once, before the workers load it
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(root), os.environ.get("PYTHONPATH")) if p)}
    init = (tmp_path / "rendezvous").as_uri()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MAILBOX_WORKER, str(r), init, str(n), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True) for r in range(2)]
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
                q.communicate()
            pytest.fail(f"a mailbox worker was not done within {timeout} s")
    return out


@pytest.mark.parametrize("mode", ["default", "stream"])
def test_mailbox_ring_on_the_card(cuda, tmp_path, mode):
    """Two processes on the card trade 500 messages one way and 500 round
    trips through a 2-slot ring (CUDA IPC, stream memory operations), every
    payload checked; in "stream" the receiver runs on a second stream."""
    for rc, out, err in _mailbox_workers(tmp_path, 500, mode):
        assert rc == 0, err[-3000:]
        assert '"bad": 0' in out, out


def test_mailbox_dead_peer_on_the_card(cuda, tmp_path):
    """A sender that dies halfway leaves its receiver's stream waiting on a
    flag; the receiver's next settle raises TimeoutError past the group's
    timeout (10 s) instead of hanging."""
    import time
    t0 = time.monotonic()
    (rc0, _out0, err0), (rc1, _o1, _e1) = _mailbox_workers(tmp_path, 64,
                                                           "die")
    assert rc1 == 7
    assert rc0 != 0 and "TimeoutError" in err0, err0[-3000:]
    assert time.monotonic() - t0 < 100


@pytest.mark.parametrize("procs,cols", [(2, 1), (4, 2)])
def test_process_mesh_mailbox_on_the_card(cuda, procs, cols):
    """lqr_tpu_torch.scaling's process mesh at its quick sizes on the card
    under the mailbox: every worker's map bit-equal to one process's, and
    with a 'cols' axis the halo messages as predicted with no host copy
    and no message of data over the group."""
    from lqr_tpu_torch import scaling
    line = scaling.multiprocess_gloo_resize("cuda", True, procs, cols,
                                            "mailbox")
    assert line["ok"] is True and line["bit_exact"] is True, line
    assert line["transport"] == "mailbox"
    if cols > 1:
        assert line["host_copies_per_seam"] == 0
        assert line["gloo_messages_per_seam"] == 0
        assert (line["halo_messages_per_seam"]
                == line["halo_messages_predicted"])
