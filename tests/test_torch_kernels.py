"""The port's kernel modules against the JAX package on the CPU.

Same numpy-seeded inputs through both; the JAX Pallas kernels run in
interpret mode, the port's wrappers take their plain PyTorch versions
(CPU tensors).  Grids and raw window sums are integers and must be
bit-equal; scaled lattice scores agree to 1e-12 (float64 on both sides).
"""
import itertools

import numpy as np
import pytest
import torch

from yag_slam_tpu.matching import correlation as JC
from yag_slam_tpu_torch.matching import correlation as TC
from yag_slam_tpu_torch.matching import kernels as K


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# -- grid build --------------------------------------------------------------

def _grid_inputs():
    """Inputs of the JAX package's fused-vs-staged test (G=700, S=512,
    out-of-grid points, far-sentinel lanes), with the second job's subgrid
    moved 40 cells past the full grid's high edge so the mask fires."""
    G, S, res = 700, 512, 0.01
    taps = tuple(float(v) for v in JC.gaussian_kernel_1d(res, 0.025))
    h = (len(taps) - 1) // 2
    N, B, P = 2, 2, 128
    rng = np.random.default_rng(11)
    wx = rng.uniform(-1.0, 8.0, (N, B, P))
    wy = rng.uniform(-1.0, 8.0, (N, B, P))
    wx[:, :, -4:] = 1e9
    wy[:, :, -4:] = 1e9
    keep = rng.uniform(size=(N, B, P)) > 0.2
    ox = np.array([0.0, -0.3])
    oy = np.array([0.1, 0.0])
    sox = np.array([0, G - S + 40], dtype=np.int32)
    soy = np.array([2, G - S + 40], dtype=np.int32)
    # occupied cells on the last full-grid column and row of job 1, whose
    # smear would spill past the grid's high edge without the mask
    edge = ox[1] + (G - 1 - np.arange(8)) * res
    wx[1, 0, :8], wy[1, 0, :8] = edge, oy[1] + 600 * res
    wx[1, 1, :8], wy[1, 1, :8] = ox[1] + 600 * res, oy[1] + (G - 1 - np.arange(8)) * res
    keep[1, :, :8] = True
    return dict(G=G, S=S, res=res, taps=taps, h=h, wx=wx, wy=wy, keep=keep,
                ox=ox, oy=oy, sox=sox, soy=soy)


@pytest.fixture(scope="module")
def jax_grids():
    d = _grid_inputs()
    Cpad = ((d["S"] + 2 * d["h"] + 127) // 128) * 128
    args = (d["wx"], d["wy"], d["keep"], d["ox"], d["oy"], d["sox"], d["soy"])
    kw = dict(G=d["G"], S=d["S"], h=d["h"], Cpad=Cpad, res=d["res"],
              taps=d["taps"], interpret=True)
    return d, {
        "fused": JC.build_quantized_grid_fused(*args, **kw),
        "strip_pallas_scatter": JC.build_quantized_grid_strip(
            *args, pallas_scatter=True, **kw),
        "strip_xla_scatter": JC.build_quantized_grid_strip(
            *args, pallas_scatter=False, **kw),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "variant", ["fused", "strip_pallas_scatter", "strip_xla_scatter"])
def test_build_quantized_grid_matches_jax(jax_grids, variant, dtype):
    d, ref = jax_grids
    q = TC.build_quantized_grid(
        _t(d["wx"], dtype), _t(d["wy"], dtype), _t(d["keep"]),
        _t(d["ox"], dtype), _t(d["oy"], dtype), _t(d["sox"]), _t(d["soy"]),
        G=d["G"], S=d["S"], h=d["h"], res=d["res"],
        taps=_t(np.float32(d["taps"])),
    )
    assert q.dtype == torch.uint8 and q.shape == (2, d["S"], d["S"])
    expect = np.asarray(ref[variant].astype(np.float32))
    np.testing.assert_array_equal(q.numpy().astype(np.float32), expect)
    # the overhanging job's cells past the full grid really were masked,
    # and the smear would have reached them
    lim_x = d["G"] - d["sox"][1]
    lim_y = d["G"] - d["soy"][1]
    assert expect[1, :, lim_x:].max() == 0 and expect[1, :, lim_x - 1].max() > 0
    assert expect[1, lim_y:, :].max() == 0 and expect[1, lim_y - 1, :].max() > 0


def test_scatter_cells_matches_jax_pallas_scatter():
    """Port scatter vs build_occupancy_pallas (interpret) on the inputs of
    the JAX package's scatter test; the layouts differ only by their
    padding, so the overlapping (S+2h)^2 window must match cell for cell."""
    G, S, h, res = 451, 512, 5, 0.01
    Cpad = ((S + 2 * h + 127) // 128) * 128
    N, B, P = 2, 2, 64
    rng = np.random.default_rng(7)
    wx = rng.uniform(-1.0, 6.0, (N, B, P))
    wy = rng.uniform(-1.0, 6.0, (N, B, P))
    wx[:, :, -4:] = 1e9
    wy[:, :, -4:] = 1e9
    keep = rng.uniform(size=(N, B, P)) > 0.2
    ox = np.array([0.0, -0.3])
    oy = np.array([0.1, 0.0])
    sox = np.array([0, 3], dtype=np.int32)
    soy = np.array([2, 0], dtype=np.int32)

    ref = np.asarray(JC.build_occupancy_pallas(
        wx, wy, keep, ox, oy, sox, soy, G=G, S=S, h=h, Cpad=Cpad, res=res,
        dtype=np.float64, interpret=True))
    sy, sx = TC.occupancy_cells(
        _t(wx), _t(wy), _t(keep), _t(ox), _t(oy), _t(sox), _t(soy),
        G=G, S=S, h=h, res=res)
    occ = K.scatter_cells(sy, sx, S + 2 * h).numpy()
    row0 = 128 - h   # JAX rows sit at +128, the port's at +h
    window = ref[:, row0:row0 + S + 2 * h, : S + 2 * h]
    np.testing.assert_array_equal(occ.astype(np.float64), window)
    assert occ.sum() > 50   # the window holds real cells


# -- float32 smear ---------------------------------------------------------------

def _smear_taps(h):
    """Symmetric positive float32 taps of any half-width (the matcher's
    Gaussian gives only even h)."""
    offs = (np.arange(2 * h + 1) - h) * 0.01
    return np.exp(-0.5 * offs**2 / 0.025**2).astype(np.float32)


def _smear_case(h, N=2, S=256):
    """Random occupancy in the port's (N, S+2h, S+2h) uint8 layout and the
    same cells in the JAX smear layout (N, S+256, Cpad) float32, where
    subgrid row r sits at row r+128 and column c at column c+h."""
    rng = np.random.default_rng(40 + h)
    R = S + 2 * h
    occ = (rng.uniform(size=(N, R, R)) < 0.02).astype(np.uint8)
    occ[:, :h + 1, :] = 1          # halo and edge rows: the halo must count
    Cpad = ((R + 127) // 128) * 128
    jax_occ = np.zeros((N, S + 256, Cpad), dtype=np.float32)
    jax_occ[:, 128 - h:128 - h + R, :R] = occ
    return occ, jax_occ, _smear_taps(h), S


# smear_grid_pallas cannot take h = 0: its empty halo slice of the previous
# strip (rows 128: of a 128-row block) is refused, in interpret mode too
@pytest.mark.parametrize("variant,h", [
    ("pallas", 2), ("pallas", 5), ("xla", 0), ("xla", 2), ("xla", 5)])
def test_smear_grid_matches_jax(variant, h):
    from yag_slam_tpu.matching import pallas_kernels as PK

    occ, jax_occ, taps, S = _smear_case(h)
    kw = dict(h=h, S=S, taps=tuple(float(t) for t in taps))
    if variant == "pallas":
        ref = PK.smear_grid_pallas(jax_occ, interpret=True, **kw)
    else:
        ref = PK.smear_grid_xla(jax_occ, **kw)
    got = K.smear_grid(_t(occ), _t(taps), S, h)
    assert got.dtype == torch.float32 and got.shape == (2, S, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.max() == 1.0 and (got.numpy() % 1.0 != 0.0).any() == (h > 0)


@pytest.mark.parametrize("h", [0, 2, 5])
def test_quantized_smear_grid_is_smear_quantize(h):
    """floor(100 x) of smear_grid masked at lim is smear_quantize, and both
    are the JAX staged build's quantize_grid + mask of smear_grid_xla."""
    from yag_slam_tpu.matching import pallas_kernels as PK

    occ, jax_occ, taps, S = _smear_case(h)
    lim = np.array([[S - 20, S - 7], [S, S]], dtype=np.int32)
    q = K.quantize_mask(K.smear_grid(_t(occ), _t(taps), S, h), _t(lim))
    np.testing.assert_array_equal(
        q.numpy(), K.smear_quantize(_t(occ), _t(lim), _t(taps), S, h).numpy())
    ref = np.array(JC.quantize_grid(PK.smear_grid_xla(
        jax_occ, h=h, S=S, taps=tuple(float(t) for t in taps))))
    ref[0, lim[0, 0]:, :] = 0.0
    ref[0, :, lim[0, 1]:] = 0.0
    np.testing.assert_array_equal(q.numpy(), ref.astype(np.uint8))
    assert q[0, S - 21].max() > 0 and q[0, S - 20:].max() == 0
    assert q[0, :, S - 7:].max() == 0 and q[1].max() == 100


# -- the {0,1} identity of the smear kernels -------------------------------------
#
# On the card neither smear does float arithmetic per cell: with occ in
# {0, 1} and taps non-increasing away from the centre, pass 1's value is the
# tap at the row distance d to the nearest occupied cell, and the output is
# max over dy of F[|dy|][d(row + dy)], F = tap * tap in float32.
# smear_quantize max-updates Q = floor(100 * F) and masks at lim;
# smear_grid max-updates F's rank among the (h+1)^2 products and maps it
# back to F (csrc/grid_build.cu).  These tests hold both designs to the
# plain versions bit for bit on the CPU.

def _tap_by_distance(taps, h):
    """tap(k) = taps[h - k] for k = 0 .. h, and tap(h + 1) = 0."""
    return torch.cat([taps[:h + 1].flip(0), torch.zeros(1, dtype=torch.float32)])


def _f_table(taps, h):
    """(h+1, h+2) float32 F[dy][d] = tap(dy) * tap(d)."""
    tap = _tap_by_distance(taps, h)
    return tap[:h + 1, None] * tap[None, :]


def _q_table(taps, h):
    """(h+1, h+2) uint8 Q[dy][d] = floor(100 * (tap(dy) * tap(d))) in
    float32, tap(k) = taps[h - k], tap(h + 1) = 0."""
    return torch.floor(_f_table(taps, h) * 100.0).to(torch.uint8)


def _rank_table(taps, h):
    """RankTable::make: the rank of F[dy][d] (dy, d <= h) is 1 + the
    number of the (h+1)^2 entries below it, 0 stands for value 0 (d = h+1:
    nothing in reach).  Returns ((h+1, h+2) uint8 ranks, (256,) float32
    rank -> value)."""
    f = _f_table(taps, h)[:, :h + 1].reshape(-1)
    rank = 1 + (f[None, :] < f[:, None]).sum(dim=1)
    assert int(rank.max()) <= 255
    val = torch.full((256,), float("nan"), dtype=torch.float32)
    val[0] = 0.0
    val[rank] = f
    codes = torch.zeros((h + 1, h + 2), dtype=torch.uint8)
    codes[:, :h + 1] = rank.reshape(h + 1, h + 1).to(torch.uint8)
    return codes, val


def _smear_by_table(occ, table, S, h):
    """max over the window of table[|dy|][d(row + dy)], d the row distance
    to the nearest occupied cell within h (h + 1: none)."""
    N, R, _ = occ.shape
    x = occ.bool()
    d = torch.full((N, R, S), h + 1, dtype=torch.int64)
    for k in range(h, -1, -1):          # nearer distances overwrite
        d = torch.where(x[:, :, h - k:h - k + S] | x[:, :, h + k:h + k + S], k, d)
    out = torch.zeros((N, S, S), dtype=table.dtype)
    for b in range(2 * h + 1):
        out = torch.maximum(out, table[abs(b - h)][d[:, b:b + S, :]])
    return out


def _smear_quantize_by_table(occ, lim, taps, S, h):
    """smear_quantize's design in plain torch: row distance, Q table,
    integer max over the window, mask at lim."""
    out = _smear_by_table(occ, _q_table(taps, h).to(torch.int64), S, h)
    ar = torch.arange(S)
    keep = (ar[None, :, None] < lim[:, 0, None, None]) & (ar[None, None, :] < lim[:, 1, None, None])
    return torch.where(keep, out, 0).to(torch.uint8)


def _binary_grid(rng, N, S, h, density):
    R = S + 2 * h
    return (rng.uniform(size=(N, R, R)) < density).astype(np.uint8)


SMEAR_LIMS = lambda S: np.array([[S, S], [S - 17, S - 40], [5, S - 1]], dtype=np.int32)  # noqa: E731


@pytest.mark.parametrize("density", [0.001, 0.01, 0.1, 0.5])
@pytest.mark.parametrize("h", [0, 1, 2, 10, 14])
def test_smear_quantize_table_identity(h, density):
    """Row distance + Q table + integer max + mask == smear_quantize_ref,
    on N = 3 seeded {0,1} grids, S = 300 (no multiple of the card's 256 x
    (128 - 2h) tile), three lims per case."""
    rng = np.random.default_rng(1000 * h + int(1000 * density))
    S = 300
    occ = _t(_binary_grid(rng, 3, S, h, density))
    taps = _t(_smear_taps(h))
    lim = _t(SMEAR_LIMS(S))
    want = K.smear_quantize_ref(occ, lim, taps, S, h)
    got = _smear_quantize_by_table(occ, lim, taps, S, h)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want[0].max() == 100 and (want[1, :, S - 40:] == 0).all()


class _QuantizeStage:
    """QuantizeTable: the code is Q itself, masked at lim, stored as bytes."""

    def __init__(self, lim, taps, h):
        self.lim, self.codes = lim.numpy(), _q_table(taps, h).numpy()
        self.unwritten = np.uint8(255)

    def rows(self, n, S):
        return min(S, self.lim[n, 0])

    def cols(self, n, S):
        return min(S, self.lim[n, 1])

    def store(self, tile):
        return tile


class _RankStage:
    """RankTable: the code is F's rank, no mask, stored as its float32."""

    def __init__(self, taps, h):
        self.codes, self.val = (t.numpy() for t in _rank_table(taps, h))
        self.unwritten = np.float32(-1.0)

    def rows(self, n, S):
        return S

    cols = rows

    def store(self, tile):
        return self.val[tile]


def _emulate_smear_identity_kernel(occ, stage, S, h):
    """smear_identity_kernel's integer steps, block by block, in Python:
    ballot-packed 32-bit row words and the rows holding any bit, four
    threads per column each owning a quarter of the output rows, the
    64-bit funnel-shifted window, ffs / clz distances, the scatter-max of
    the stage's codes into the tile (up to its row and column limits), the
    tile written out through the stage's store."""
    occ = occ.numpy()
    N, R, _ = occ.shape
    cols, staged, words = 256, 128, (256 + 63) // 32 + 1
    rows_out = staged - 2 * h
    code = stage.codes
    win, low = (1 << (2 * h + 1)) - 1, (1 << (h + 1)) - 1
    out = np.full((N, S, S), stage.unwritten)     # every cell must be written
    for n in range(N):
        for r0 in range(0, S, rows_out):
            for c0 in range(0, S, cols):
                bits = np.zeros((staged, words), dtype=np.uint64)
                row_words = [0] * (staged // 32)
                for i in range(staged):
                    for w in range(words):
                        for lane in range(32):
                            j = 32 * w + lane
                            if r0 + i < R and j < cols + 2 * h and c0 + j < R \
                                    and occ[n, r0 + i, c0 + j]:
                                bits[i, w] |= np.uint64(1 << lane)
                    if bits[i].any():
                        row_words[i >> 5] |= 1 << (i & 31)
                tile = np.zeros((staged, cols), dtype=np.uint8)
                rows_hi = int(min(rows_out, stage.rows(n, S) - r0))
                per = -(-rows_out // 4)
                for part, c in itertools.product(range(4), range(cols)):
                    p_lo, p_hi = part * per, min(rows_hi, part * per + per)
                    if c0 + c >= stage.cols(n, S) or p_lo >= p_hi:
                        continue
                    i_hi = min(p_hi - 1 + 2 * h, staged - 1)
                    marked = []
                    for k in range(p_lo >> 5, (i_hi >> 5) + 1):
                        rows = row_words[k]
                        if k == p_lo >> 5:
                            rows &= (0xFFFFFFFF << (p_lo & 31)) & 0xFFFFFFFF
                        if k == i_hi >> 5 and (i_hi & 31) != 31:
                            rows &= (1 << ((i_hi & 31) + 1)) - 1
                        marked += [32 * k + b for b in range(32) if rows >> b & 1]
                    wi, off = c >> 5, c & 31
                    for i in marked:
                        v = (int(bits[i, wi + 1]) << 32) | int(bits[i, wi])
                        if off:
                            v = ((v >> off) | (int(bits[i, wi + 2]) << (64 - off))) & (2**64 - 1)
                        v &= win
                        if not v:
                            continue
                        left, right = v & low, v >> h
                        d = h + 1
                        if right:
                            d = (right & -right).bit_length() - 1   # __ffsll - 1
                        if left:
                            d = min(d, h - (left.bit_length() - 1))  # 63 - __clzll
                        for r in range(max(p_lo, i - 2 * h), min(p_hi, i + 1)):
                            tile[r, c] = max(tile[r, c], code[abs(i - r - h), d])
                rows, cs = min(rows_out, S - r0), min(cols, S - c0)
                out[n, r0:r0 + rows, c0:c0 + cs] = stage.store(tile[:rows, :cs])
    return torch.as_tensor(out)


@pytest.mark.parametrize("h,density", [(0, 0.05), (2, 0.5), (10, 0.01), (14, 0.002)])
def test_smear_quantize_kernel_steps_emulated(h, density):
    """The CUDA kernel's bit-level steps, emulated over two column tiles and
    three row tiles, equal the plain version bit for bit."""
    rng = np.random.default_rng(7 + h)
    S, N = 270, 1
    occ = _binary_grid(rng, N, S, h, density)
    occ[0, h + 99:h + 102, 250:262] = 1     # across the row and column tile seams
    occ, taps = _t(occ), _t(_smear_taps(h))
    lim = _t(np.array([[S - 3, S - 11]], dtype=np.int32))
    want = K.smear_quantize_ref(occ, lim, taps, S, h)
    got = _emulate_smear_identity_kernel(occ, _QuantizeStage(lim, taps, h), S, h)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.max() == 100


@pytest.mark.parametrize("density", [0.001, 0.01, 0.1, 0.5])
@pytest.mark.parametrize("h", [0, 1, 2, 10, 14])
def test_smear_grid_table_identity(h, density):
    """Row distance + F table + max, and the same max taken on F's ranks
    and mapped back, == smear_grid_ref, on N = 3 seeded {0,1} grids at
    S = 301 (no multiple of the 256 x (128 - 2h) tile, nor of 4)."""
    rng = np.random.default_rng(2000 * h + int(1000 * density))
    S = 301
    occ = _t(_binary_grid(rng, 3, S, h, density))
    taps = _t(_smear_taps(h))
    want = K.smear_grid_ref(occ, taps, S, h)
    np.testing.assert_array_equal(_smear_by_table(occ, _f_table(taps, h), S, h).numpy(),
                                  want.numpy())
    codes, val = _rank_table(taps, h)
    ranks = _smear_by_table(occ, codes.to(torch.int64), S, h)
    np.testing.assert_array_equal(val[ranks].numpy(), want.numpy())
    assert want.max() == 1.0 and want.dtype == torch.float32


@pytest.mark.parametrize("h,density", [(0, 0.05), (2, 0.5), (10, 0.01), (14, 0.002)])
def test_smear_grid_kernel_steps_emulated(h, density):
    """The identity kernel with the rank table and the float32 store,
    emulated over two column tiles and three row tiles, equals
    smear_grid_ref bit for bit; quantized and masked it is smear_quantize."""
    rng = np.random.default_rng(17 + h)
    S, N = 270, 1
    occ = _binary_grid(rng, N, S, h, density)
    occ[0, h + 99:h + 102, 250:262] = 1     # across the row and column tile seams
    occ[0, h + 2 * (128 - 2 * h) - 1, 3] = 1   # the last output row of a row tile
    occ, taps = _t(occ), _t(_smear_taps(h))
    want = K.smear_grid_ref(occ, taps, S, h)
    got = _emulate_smear_identity_kernel(occ, _RankStage(taps, h), S, h)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    lim = _t(np.array([[S - 3, S - 11]], dtype=np.int32))
    np.testing.assert_array_equal(K.quantize_mask(got, lim).numpy(),
                                  K.smear_quantize_ref(occ, lim, taps, S, h).numpy())
    assert want.max() == 1.0


def test_rank_table_orders_as_the_products():
    """Ranks fit a byte up to h = 14, equal products share a rank, and the
    rank order is the value order."""
    for h in (0, 1, 2, 10, 14):
        codes, val = _rank_table(_t(_smear_taps(h)), h)
        f = _f_table(_t(_smear_taps(h)), h)
        assert int(codes.max()) <= (h + 1) ** 2 <= 225
        assert (codes[:, h + 1] == 0).all() and (codes[:, :h + 1] > 0).all()
        flat_c, flat_f = codes[:, :h + 1].reshape(-1), f[:, :h + 1].reshape(-1)
        assert torch.equal(val[flat_c.long()], flat_f)
        less = flat_f[:, None] < flat_f[None, :]
        assert torch.equal(less, flat_c[:, None] < flat_c[None, :])


# -- scatter_cells: fill and scatter in one launch --------------------------------

def _band_rows(N, R, sms):
    """yag_scatter_cells' band height: about two blocks per SM, every job at
    least one band."""
    return min(R, max(1, -(-N * R // (2 * sms))))


def _emulate_scatter_cells_kernel(sy, sx, R, sms=132, base=0, threads=512):
    """yag_scatter_cells' bands and scatter_cells_kernel's steps in numpy,
    on a grid of non-zero garbage at an address that is `base` mod 16:
    each block zeroes its band's bytes as a head up to 16-byte alignment,
    the aligned body and a tail, then stores the ones of the lanes whose
    row is in its band.  Checks that the bands cover every byte once."""
    sy, sx = sy.numpy(), sx.numpy()
    N, M = sy.shape
    band_rows = _band_rows(N, R, sms)
    bands = -(-R // band_rows)
    occ = np.random.default_rng(R).integers(1, 256, N * R * R).astype(np.uint8)
    zeroed = np.zeros(N * R * R, dtype=np.int64)
    for blk in range(N * bands):
        n = blk // bands
        r_lo = (blk - n * bands) * band_rows
        r_hi = min(R, r_lo + band_rows)
        a, b = (n * R + r_lo) * R, (n * R + r_hi) * R
        a16 = a + min(b - a, (16 - (base + a) % 16) % 16)
        b16 = a16 + ((b - a16) & ~15)
        assert a16 - a < min(16, threads) and b - b16 < min(16, threads)
        assert (b16 - a16) % 16 == 0 and (a16 == b16 or (base + a16) % 16 == 0)
        for lo, hi in ((a, a16), (a16, b16), (b16, b)):
            occ[lo:hi] = 0
            zeroed[lo:hi] += 1
        ys, xs = sy[n], sx[n]
        mine = (ys >= r_lo) & (ys < r_hi)
        mine &= (xs >= 0) & (xs < R)
        occ[(n * R + ys[mine].astype(np.int64)) * R + xs[mine]] = 1
    assert (zeroed == 1).all()
    return torch.as_tensor(occ.reshape(N, R, R)), N * bands


@pytest.mark.parametrize("N,R,M,sms,base", [
    (1, 3092, 4096, 132, 0),   # sequential main path, largest grid: bands of 12 rows
    (1, 1812, 4096, 132, 0),   # its most common grid: bands of 7 rows
    (4, 772, 4096, 132, 0),    # loop main path: 65 bands per job
    (1, 3092, 4096, 132, 5),   # ragged heads and tails at every band
    (2, 37, 8, 132, 11),       # one 37-byte row per band
    (3, 3, 2, 132, 15),        # 3-byte bands: no aligned body
    (1, 300, 4096, 1, 3),      # one band for the whole grid
])
def test_scatter_cells_banded_fill_emulated(N, R, M, sms, base):
    rng = np.random.default_rng(N * R + base)
    sy = rng.integers(-3, R + 3, (N, M)).astype(np.int32)   # rows off the grid
    sx = rng.integers(-3, R + 3, (N, M)).astype(np.int32)   # columns off the grid
    sy[rng.uniform(size=(N, M)) < 0.3] = -1                  # empty lanes
    band = _band_rows(N, R, sms)
    edges = np.arange(0, R, band)
    k = min(len(edges), M // 2)
    sy[:, :k] = edges[:k]                                    # first row of a band
    sy[:, k:2 * k] = np.minimum(edges[:k] + band - 1, R - 1)  # last row of a band
    sx[:, :2 * k] = rng.integers(0, R, (N, 2 * k))
    sy, sx = _t(sy), _t(sx)
    want = K.scatter_cells_ref(sy, sx, R)
    got, blocks = _emulate_scatter_cells_kernel(sy, sx, R, sms=sms, base=base)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.sum() > 0 and N <= blocks <= 2 * sms + N   # about two per SM


@pytest.mark.parametrize("res,smear,h", [
    (0.01, 0.05, 10),    # default sequential
    (0.05, 0.05, 2),     # default loop
    (0.01, 0.07, 14),    # node-default sequential
    (0.05, 0.03, 2),     # node-default loop
])
def test_matcher_taps_fit_the_table_identity(res, smear, h):
    """The taps of the seq, loop and node-default configs are symmetric,
    positive and non-increasing away from the centre, as the kernel needs;
    the matcher checks them once, when it makes them."""
    taps = TC.gaussian_kernel_1d(res, smear).astype(np.float32)
    assert len(taps) == 2 * h + 1
    assert TC.check_smear_taps(taps) is taps
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher

    cfg = {"resolution": res, "smear_deviation": smear}
    np.testing.assert_array_equal(
        CorrelativeScanMatcher(cfg, device="cpu")._taps.numpy(), taps)


@pytest.mark.parametrize("taps", [
    [0.5, 1.0, 0.7],                 # not symmetric
    [0.9, 0.5, 1.0, 0.5, 0.9],       # rises away from the centre
    [0.0, 1.0, 0.0],                 # not positive
])
def test_check_smear_taps_refuses_other_shapes(taps):
    with pytest.raises(ValueError, match="non-increasing"):
        TC.check_smear_taps(np.asarray(taps, dtype=np.float32))


# -- window sum ----------------------------------------------------------------

def _lattice_inputs(stride, n_per_job):
    """Inputs of the JAX package's scorer tests: windows overhanging every
    grid edge, far-sentinel lanes, per-job point counts."""
    G, S, N, res = 451, 512, 2, 0.01
    xy_res = res * stride
    spec = JC.LatticeSpec.from_search(0.0, 0.0, 0.0, 12.5 * xy_res, xy_res,
                                      0.1745, 0.0349)
    rng = np.random.default_rng(11)
    q2d = np.floor(rng.uniform(0, 100, (N, S, S)))
    q2d[:, G:, :] = 0.0
    q2d[:, :, G:] = 0.0
    P = 96
    px = rng.uniform(-1.0, 6.0, (N, P))
    py = rng.uniform(-1.0, 6.0, (N, P))
    for j in range(N):
        px[j, n_per_job[j]:] = 1e9
        py[j, n_per_job[j]:] = 1e9
    n_pts = np.asarray(n_per_job, dtype=np.float64)
    args = (px, py, n_pts, np.array([0.3, 4.2]), np.array([0.2, 4.4]),
            np.array([0.0, 0.4]), np.zeros(N), np.zeros(N),
            np.zeros(N, dtype=np.int32), np.zeros(N, dtype=np.int32))
    kw = dict(spec=spec, xy_size=12.5 * xy_res, xy_res=xy_res, ang_size=0.1745,
              ang_res=0.0349, grid_size=G, grid_res=res, penalize=True)
    return q2d, args, kw, S


@pytest.mark.parametrize("scorer,stride", [
    ("roll", 1), ("roll", 2),
    ("mxu", 1), ("mxu", 2), ("mxu", 3),
    ("patch", 1), ("patch", 2),
    ("hybrid", 1), ("hybrid", 2),
])
def test_score_lattice_matches_jax(scorer, stride):
    n_per_job = [96 - 8, 96 - 23] if scorer == "mxu" else [96 - 8, 96 - 8]
    q2d, args, kw, S = _lattice_inputs(stride, n_per_job)
    jkw = dict(kw, sub_size=S, dtype=np.float64)
    if scorer in ("roll", "hybrid"):
        ref = JC.score_lattice_vmem_batched(q2d, *args, interpret=True,
                                            hybrid=scorer == "hybrid", **jkw)
    elif scorer == "mxu":
        ref = JC.score_lattice_mxu_batched(q2d, *args, interpret=True, **jkw)
    else:
        ref = JC.score_lattice_patch_batched(q2d, *args, **jkw)
    got = TC.score_lattice(_t(q2d.astype(np.uint8)), *map(_t, args), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)


def test_window_sum_plain_matches_loop():
    """window_sum's plain version against a direct per-point loop, with
    negative starts, reads past S and a per-job point count."""
    rng = np.random.default_rng(3)
    N, S, K_, P, ny, nx, stride = 2, 40, 3, 17, 5, 6, 3
    q = rng.integers(0, 101, (N, S, S)).astype(np.uint8)
    gy0 = rng.integers(-20, S + 5, (N, K_, P)).astype(np.int32)
    gx0 = rng.integers(-20, S + 5, (N, K_, P)).astype(np.int32)
    n_pts = np.array([P, 9], dtype=np.int32)
    want = np.zeros((N, K_, ny, nx), dtype=np.int64)
    for n in range(N):
        for k in range(K_):
            for p in range(n_pts[n]):
                for j in range(ny):
                    for i in range(nx):
                        y = gy0[n, k, p] + stride * j
                        x = gx0[n, k, p] + stride * i
                        if 0 <= y < S and 0 <= x < S:
                            want[n, k, j, i] += q[n, y, x]
    got = K.window_sum(_t(q), _t(gy0), _t(gx0), _t(n_pts), ny, nx, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _window_sum_by_kernel_tiling(q, gy0, gx0, n_pts, ny, nx, stride, sms=132):
    """yag_window_sum's launch choice and output mapping in Python: the
    per-output kernel (thread = output over all points) for many outputs,
    else the split kernel (warp = up to 4 outputs, lane = every 32nd
    point, then a warp sum); every output must be stored exactly once."""
    N, S, _ = q.shape
    _, K_, P_ = gy0.shape
    n_out = ny * nx
    per_output = N * K_ * n_out >= 8 * 32 * sms
    ow, warps = 4, 8
    while not (per_output or N * K_ * -(-n_out // (ow * warps)) >= 2 * sms
               or (ow, warps) == (1, 1)):
        ow, warps = (ow // 2, warps) if ow > 1 else (ow, warps // 2)
    lanes = 1 if per_output else 32      # lanes that split one output's points
    tiles = -(-n_out // 256) if per_output else -(-n_out // (ow * warps))
    out = torch.full((N, K_, ny, nx), -1, dtype=torch.int32)
    for n in range(N):
        m = int(min(max(int(n_pts[n]), 0), P_))
        for k in range(K_):
            # partial[l] = the sum over points p = l, l + lanes, ... < m
            partial = [K.window_sum_ref(
                q[n:n + 1], gy0[n:n + 1, k:k + 1, l:m:lanes].contiguous(),
                gx0[n:n + 1, k:k + 1, l:m:lanes].contiguous(),
                torch.tensor([len(range(l, m, lanes))], dtype=torch.int32),
                ny, nx, stride)[0, 0].reshape(-1) for l in range(lanes)]
            flat = out[n, k].reshape(-1)
            for tile in range(tiles):                       # blockIdx.z
                if per_output:
                    outs = [tile * 256 + t for t in range(256)]
                else:
                    outs = [(tile * warps + w) * ow + u for w in range(warps) for u in range(ow)]
                for o in outs:
                    if o < n_out:
                        assert flat[o] == -1, "stored twice"
                        flat[o] = sum(int(pl[o]) for pl in partial)
    return out


@pytest.mark.parametrize("shape", [
    (1, 10, 4, 4, 1),      # seq fine: 160 outputs, lanes on points
    (1, 10, 25, 25, 2),    # seq coarse: 6250
    (4, 10, 30, 30, 2),    # 36000 outputs: one output per lane
])
def test_window_sum_kernel_tiling_emulated(shape):
    N, K_, ny, nx, stride = shape
    rng = np.random.default_rng(sum(shape))
    S, P_ = 90, 70
    q = _t(rng.integers(0, 101, (N, S, S)).astype(np.uint8))
    gy0 = _t(rng.integers(-20, S + 5, (N, K_, P_)).astype(np.int32))
    gx0 = _t(rng.integers(-20, S + 5, (N, K_, P_)).astype(np.int32))
    n_pts = _t(rng.integers(40, P_ + 1, N).astype(np.int32))
    want = K.window_sum_ref(q, gy0, gx0, n_pts, ny, nx, stride)
    got = _window_sum_by_kernel_tiling(q, gy0, gx0, n_pts, ny, nx, stride)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_world_to_grid_idx_clamps_far_lanes():
    """Far-sentinel lanes (~1e11 cells) clamp before the int32 cast."""
    w = torch.tensor([1e9, -1e9, 0.015, 0.025, -0.005], dtype=torch.float64)
    g = TC.world_to_grid_idx(w, 0.0, 0.01)
    assert g.dtype == torch.int32
    assert g.tolist() == [2**30, -(2**30), 2, 2, 0]   # half to even
