"""The scans' rows form on the CPU: the contract the CUDA kernels implement.

``scan_pair`` and ``scan_blocks`` read the grower's histogram planes in
place, through the children's rows (and, for scan_pair, the layout's
``gidx``). Their function is the plain version of the gathered planes:

  * ``scan_pair(..., rows=, gidx=)`` on [L, TBp] planes equals
    ``scan_pair_plain`` of ``gh[rows][:, gidx]``, bit for bit, and the
    gathered form is its special case (rows = arange(B), identity gidx);
  * ``scan_blocks(..., rows=, groups=G)`` on [L, G * W] planes equals
    ``scan_blocks_plain`` of the zero-padded ``gh[rows]``, with G < Gp and
    W <= Wp;

for random rows of the planes, B in {1, 2, 256} and Wp in {32, 256}.

Two properties the kernels' design rests on are checked on the plain
versions: the count rows (floor(h * cf + 0.5) times a 0/1 mask) are
integer-valued, so their f64 prefix sums are exact and equal in any order
while they stay below 2^53 (a blocked, parallel-scan order gives the same
bits; non-integer values do not); and the tie and +inf rules: with
l2 = 0 and a zero-hessian side a gain is +inf, REVERSE keeps the highest
threshold among equal gains and forward the lowest, and in the block scan
an inf gain times a zero penalty (NaN) leaves its direction without a
split. The builders here are shared with tests/test_torch_scan_cuda.py,
which holds the kernels to the same plain versions on the card.
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import block_scan as bs
from lightgbm_torch.ops.scan import (ScanLayout, _prefix, knob_scalars,
                                     pair_scalars, scan_pair,
                                     scan_pair_plain, scan_pair_rows_plain)
from lightgbm_torch.ops.split import SplitParams

F32 = np.float32


def child_planes(rng, L, starts, nb, zero_hess=0.0, rows_per=(20, 400)):
    """[L, TB] f32 grad/hess planes of L random children and each child's
    (sum_grad, sum_hess, count): child l histograms its own rows, each row
    in one random bin of every feature (feature f's bins at lanes starts[f]
    to starts[f] + nb[f] - 1), so every feature's bins add up to the same
    totals. Few rows against many bins leave empty bins, whose thresholds
    tie exactly; a `zero_hess` share of rows has hessian 0."""
    TB = int(np.max(np.asarray(starts) + np.asarray(nb)))
    gp = np.zeros((L, TB), F32)
    hp = np.zeros((L, TB), F32)
    sums = []
    for l in range(L):
        n = int(rng.integers(*rows_per))
        g = rng.normal(size=n).astype(F32)
        h = rng.uniform(0.05, 0.25, n).astype(F32)
        h[rng.random(n) < zero_hess] = 0
        for s0, k in zip(starts, nb):
            b = s0 + rng.integers(0, k, n)
            np.add.at(gp[l], b, g)
            np.add.at(hp[l], b, h)
        sums.append((F32(g.sum(dtype=np.float64)),
                     F32(h.sum(dtype=np.float64)), n))
    return gp, hp, sums


# feature metadata of the scan_pair cases: missing types None, Zero and NaN,
# a one-bin feature (no threshold) and one masked out of the tree
PAIR_MT = [0, 1, 2, 2, 0, 1, 0]
PAIR_DB = [0, 3, 0, 0, 0, 1, 0]
PAIR_PEN = [1.0, 1.0, 0.5, 1.0, 1.25, 1.0, 1.0]
PAIR_MASK = [True, True, True, True, True, True, False]


def pair_case(seed, B, Wp, L=None, l2=0.5, min_data=3, min_hess=1e-3,
              zero_hess=0.0, batched=False):
    """Inputs of scan_pair's rows form on the CPU: a dict with the planes
    gh/hh [L, TB], rows [B] (a random choice of distinct plane rows), the
    [B, 8] scalars and a ScanLayout's masks and gidx cut to Wp lanes.
    Feature widths fit Wp (Wp = 32: at most 32 bins)."""
    rng = np.random.default_rng(seed)
    top = Wp if Wp == 32 else Wp - 1      # 1023 bins give Wp = 1024
    nb = np.array([top, max(top // 3, 2), top - 1, 2, 1, 17, top // 2])
    starts = np.concatenate([[0], np.cumsum(nb)[:-1]])
    L = L or B + 5
    gp, hp, sums = child_planes(rng, L, starts, nb, zero_hess)
    layout = ScanLayout(starts, starts + nb, PAIR_MT, PAIR_DB, PAIR_PEN,
                        PAIR_MASK, int(nb.max()), gp.shape[1], "cpu")

    def cut(t):
        return t[..., :Wp].contiguous()
    rows = rng.choice(L, B, replace=False)
    scal = pair_scalars([sums[r][0] for r in rows], [sums[r][1] for r in rows],
                        [sums[r][2] for r in rows], l2, 0.0, min_data,
                        min_hess)
    valid_r, valid_f = cut(layout.valid_r), cut(layout.valid_f)
    if batched:          # every other child loses every other feature
        off = torch.as_tensor(np.arange(layout.Fp) % 2 == 1)[:, None]
        odd = torch.as_tensor(np.arange(B) % 2 == 1)[:, None, None]
        valid_r = torch.where(odd & off, 0.0, valid_r.expand(B, -1, -1))
        valid_f = torch.where(odd & off, 0.0, valid_f.expand(B, -1, -1))
        valid_r, valid_f = valid_r.contiguous(), valid_f.contiguous()
    return {"scal": torch.as_tensor(scal), "gh": torch.as_tensor(gp),
            "hh": torch.as_tensor(hp), "rows": torch.as_tensor(rows),
            "gidx": cut(layout.gidx), "keep_r": cut(layout.keep_r),
            "keep_f": cut(layout.keep_f), "valid_r": valid_r,
            "valid_f": valid_f, "aux": layout.aux, "F": len(nb)}


# monotone signs of the knob cases' features
KNOB_MONO = [1, -1, 0, 1, 0, -1, 1]


def knob_case(seed, B, Wp, l1=0.5, mds=0.3, use_mc=True, rand=0.5,
              drop=0.3, **kw):
    """A pair_case with the knob form's inputs: the [B, 16] scalars
    (lambda_l1, max_delta_step, finite monotone bounds drawn per child),
    the KNOB_MONO signs in aux row 1, and ``node`` [B, 2, Fp]: a random
    extra_trees lane for a `rand` share of (child, feature) pairs (-1
    elsewhere) and a by-node mask dropping a `drop` share. Returns the case
    dict with "node" added and "scal" replaced."""
    c = pair_case(seed, B, Wp, **kw)
    rng = np.random.default_rng(seed + 1)
    s8 = c["scal"].numpy()
    p = SplitParams(lambda_l2=float(s8[0, 7]), min_gain_to_split=0.0,
                    min_data_in_leaf=int(s8[0, 4]),
                    min_sum_hessian_in_leaf=float(s8[0, 5]),
                    lambda_l1=l1, max_delta_step=mds)
    cmin = -rng.uniform(0.05, 0.4, B).astype(F32)
    cmax = rng.uniform(0.05, 0.4, B).astype(F32)
    cmin[::3], cmax[1::3] = -np.inf, np.inf
    scal = knob_scalars(s8[:, 0], s8[:, 1], s8[:, 2], p, cmin, cmax,
                        use_mc)
    Fp = c["aux"].shape[1]
    aux = c["aux"].clone()
    aux[1, :len(KNOB_MONO)] = torch.as_tensor(KNOB_MONO, dtype=torch.float32)
    lanes = rng.integers(0, Wp, (B, Fp)).astype(F32)
    node = np.stack([np.where(rng.random((B, Fp)) < rand, lanes, F32(-1)),
                     (rng.random((B, Fp)) >= drop).astype(F32)], 1)
    return dict(c, scal=torch.as_tensor(scal), aux=aux,
                node=torch.as_tensor(np.ascontiguousarray(node, F32)))


def pair_args(c):
    """scan_pair's positional arguments of a pair_case, rows form."""
    return (c["scal"], c["gh"], c["hh"], c["keep_r"], c["keep_f"],
            c["valid_r"], c["valid_f"], c["aux"])


def pair_gathered(c):
    """The same scan in the gathered form: [B, Fp, Wp] planes."""
    gb = c["gh"][c["rows"]][:, c["gidx"]].contiguous()
    hb = c["hh"][c["rows"]][:, c["gidx"]].contiguous()
    return (c["scal"], gb, hb) + pair_args(c)[3:]


def block_geometry(Wp):
    """A group layout of every window kind for a plane of Wp lanes: one-hot
    bundles (two-lane windows from lane 1, lane 0 the bundle's shared bin,
    FixHistogram at each window's first lane), one-lane windows, a dense
    singleton as wide as the group (NaN missing type), windows of mixed
    widths, and a dense Zero-missing feature. Returns the arguments of
    build_block_scan_meta (group_of, ls, nb, mt, db, mf, needs_fix,
    penalty) and G."""
    feats = []                 # (group, ls, nb, mt, db, mf, fix)
    for i in range((Wp - 1) // 2):               # group 0: one-hot bundle
        feats.append((0, 1 + 2 * i, 2, 0, 0, 0, True))
    for i in range(min(Wp - 1, 40)):             # group 1: one-lane windows
        feats.append((1, 1 + i, 1, 0, 0, 0, True))
    feats.append((2, 0, Wp - 1, 2, 0, Wp // 2, False))       # dense, NaN
    ls = 1
    for k, mt in zip((Wp // 8, 2, Wp // 4, 3), (1, 2, 0, 2)):
        feats.append((3, ls, k, mt, 1 if mt == 1 else 0, 0, True))
        ls += k
    feats.append((4, 0, Wp // 2, 1, 2, 2, False))            # dense, Zero
    a = np.array(feats, dtype=np.int64).T
    pen = np.ones(a.shape[1])
    pen[::7] = 0.75
    return (a[0], a[1], a[2], a[3], a[4], a[5], a[6].astype(bool), pen), 5


def block_planes(rng, L, meta, G, W, zero_hess=0.0):
    """[L, G * W] f32 planes of L random children over the block layout
    `meta` (build_block_scan_meta's dict), and the [L, 9] scalars: each row
    lands on one lane of every group, on an owned lane or (with probability
    1/2 in a bundle) its lane 0."""
    owned = meta["has_owner"][:G, :W]
    gp = np.zeros((L, G, W), F32)
    hp = np.zeros((L, G, W), F32)
    sg, sh, cnt = [], [], []
    for l in range(L):
        n = int(rng.integers(30, 400))
        g = rng.normal(size=n).astype(F32)
        h = rng.uniform(0.05, 0.25, n).astype(F32)
        h[rng.random(n) < zero_hess] = 0
        for grp in range(G):
            lanes = np.flatnonzero(owned[grp])
            pick = lanes[rng.integers(0, len(lanes), n)]
            if lanes[0] > 0:                      # a bundle: lane 0 too
                pick = np.where(rng.random(n) < 0.5, 0, pick)
            np.add.at(gp[l, grp], pick, g)
            np.add.at(hp[l, grp], pick, h)
        sg.append(F32(g.sum(dtype=np.float64)))
        sh.append(F32(h.sum(dtype=np.float64)))
        cnt.append(n)
    return gp.reshape(L, G * W), hp.reshape(L, G * W), (sg, sh, cnt)


def block_case(seed, B, Wp, l2=0.5, min_data=3, min_hess=1e-3,
               zero_hess=0.0, zero_pen=False):
    """Inputs of scan_blocks' rows form on the CPU: planes gh/hh [L, G * W]
    (W = Wp, G = 5 < Gp = 8), rows [B], the [B, 9] scalars and the mask
    stack [8, Gp, Wp] of block_geometry."""
    rng = np.random.default_rng(seed)
    geo, G = block_geometry(Wp)
    if zero_pen:
        geo = geo[:7] + (np.zeros_like(geo[7]),)
    meta = bs.build_block_scan_meta(*geo, G, W=Wp)
    masks = meta["masks"][:, :, :Wp]             # Wp = 32: cut from 128
    L = B + 7
    gp, hp, (sg, sh, cnt) = block_planes(rng, L, meta, G, Wp, zero_hess)
    rows = rng.choice(L, B, replace=False)
    scal = pair_scalars(np.array(sg)[rows], np.array(sh)[rows],
                        np.array(cnt)[rows], l2, 0.0, min_data, min_hess)
    scal9 = np.concatenate([scal, np.array(sh, F32)[rows, None]], axis=1)
    return {"scal": torch.as_tensor(scal9), "gh": torch.as_tensor(gp),
            "hh": torch.as_tensor(hp), "rows": torch.as_tensor(rows),
            "G": G, "masks": torch.as_tensor(np.ascontiguousarray(masks)),
            "do_fix": bool(geo[6].any())}


def block_gathered(c):
    """The same scan in the gathered form: [B, Gp, Wp] padded planes."""
    Gp, Wp = c["masks"].shape[1:]
    B, G = len(c["rows"]), c["G"]
    W = c["gh"].shape[1] // G
    pad = (0, Wp - W, 0, Gp - G)
    return [torch.nn.functional.pad(p[c["rows"]].reshape(B, G, W), pad)
            for p in (c["gh"], c["hh"])]


@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("Wp", [32, 256])
def test_scan_pair_rows_form_is_the_gathered_scan(B, Wp):
    c = pair_case(10 + B, B, Wp)
    got = scan_pair(*pair_args(c), rows=c["rows"], gidx=c["gidx"])
    want = scan_pair_plain(*pair_gathered(c))
    assert torch.equal(got, want)
    assert torch.equal(got, scan_pair_rows_plain(
        c["scal"], c["gh"], c["hh"], c["rows"], c["gidx"], *pair_args(c)[3:]))
    assert torch.equal(scan_pair(*pair_gathered(c)), want)
    has = want[:, 6, :c["F"]] > 0
    assert has.sum() >= B                  # real splits
    assert not has[:, 4].any() and not has[:, 6].any()   # no threshold


@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("Wp", [32, 256])
def test_scan_blocks_rows_form_is_the_padded_gathered_scan(B, Wp):
    c = block_case(20 + B, B, Wp)
    Gp = c["masks"].shape[1]
    assert c["G"] < Gp
    got = bs.scan_blocks(c["scal"], c["gh"], c["hh"], c["masks"],
                         c["do_fix"], rows=c["rows"], groups=c["G"])
    gb, hb = block_gathered(c)
    want = bs.scan_blocks_plain(c["scal"], gb, hb, c["masks"], c["do_fix"])
    assert torch.equal(got, want)
    assert got.shape == (B, 8, Gp)
    assert (want[:, 6, :c["G"]] > 0).sum() >= B
    assert not (want[:, 6, c["G"]:] > 0).any()       # padded groups


def test_scan_pair_batched_valid_rows_form():
    c = pair_case(3, 4, 256, batched=True)
    got = scan_pair(*pair_args(c), rows=c["rows"], gidx=c["gidx"])
    assert torch.equal(got, scan_pair_plain(*pair_gathered(c)))
    assert not (got[1::2, 6, 1::2] > 0).any()


def test_wrappers_refuse_a_half_rows_form():
    from lightgbm_torch.utils.log import LightGBMError
    c = pair_case(4, 2, 256)
    with pytest.raises(LightGBMError, match="rows and gidx"):
        scan_pair(*pair_args(c), rows=c["rows"])
    with pytest.raises(LightGBMError, match="rows"):
        scan_pair(*pair_args(c), rows=c["rows"].int(), gidx=c["gidx"])
    b = block_case(4, 2, 256)
    with pytest.raises(LightGBMError, match="rows and groups"):
        bs.scan_blocks(b["scal"], b["gh"], b["hh"], b["masks"], True,
                       rows=b["rows"])
    with pytest.raises(LightGBMError, match="groups"):
        bs.scan_blocks(b["scal"], b["gh"], b["hh"], b["masks"], True,
                       rows=b["rows"], groups=3)


def _blocked_prefix(x, block=8):
    """Inclusive f64 prefix sums along the last axis in a parallel scan's
    order: each block of lanes summed locally, the block totals scanned,
    each block's offset added to its local sums; rounded to f32."""
    x = x.double()
    n = x.shape[-1]
    out = torch.empty_like(x)
    off = torch.zeros(x.shape[:-1], dtype=torch.float64)
    for a in range(0, n, block):
        local = torch.zeros_like(off)
        for w in range(a, min(a + block, n)):
            local = local + x[..., w]
            out[..., w] = local + off
        off = off + local
    return out.float()


def _count_rows(c):
    """The plain scan_pair's two count rows of a pair_case (the gathered
    planes)."""
    scal, gb, hb, keep_r, keep_f = pair_gathered(c)[:5]
    cf = scal[:, 3, None, None]
    cnt = torch.floor(hb * cf + 0.5)
    return cnt * keep_r, cnt * keep_f


def test_count_chains_are_exact_in_any_order():
    """Integer-valued f32 values sum exactly in f64 while the sums stay below
    2^53, so the count rows' prefix sums are the same bits in any order:
    the plain version's sequential cumsum equals a blocked (parallel scan)
    order at every lane. Values that are not integers (the grad rows) do
    not have this property in general: there the order is part of the
    contract."""
    c = pair_case(7, 64, 256)
    for row in _count_rows(c):
        assert torch.equal(row, torch.floor(row))          # integer-valued
        for block in (4, 8, 32):
            assert torch.equal(_prefix(row), _blocked_prefix(row, block))
    # the argument's bound matters: integer values past 2^53 lose bits
    big = torch.tensor([[[1.0, 1.0, 2.0 ** 60, -2.0 ** 60]]])
    assert torch.equal(big, torch.floor(big))
    assert not torch.equal(_prefix(big), _blocked_prefix(big, 2))
    # and so does a row that is not integer-valued
    frac = torch.tensor([[[2.0 ** -60, 2.0 ** -60, 1.0, -1.0]]])
    assert not torch.equal(_prefix(frac), _blocked_prefix(frac, 2))


def test_scan_pair_plain_infinite_gain_and_ties():
    """l2 = 0 and rows of zero hessian: a side of only such rows has a
    hessian sum of 0 and a gain of +inf, which is valid (min_sum_hessian 0,
    min_data 0). Among the +inf thresholds REVERSE keeps the highest and
    forward the lowest; forward wins only on a strictly greater gain."""
    c = pair_case(5, 8, 256, l2=0.0, min_data=0, min_hess=0.0,
                  zero_hess=0.3)
    out = scan_pair_plain(*pair_gathered(c))
    gain = out[:, 0, :c["F"]]
    assert (gain == float("inf")).any()
    checked = 0
    for b, f in zip(*torch.nonzero(gain == float("inf"), as_tuple=True)):
        t, use_f = int(out[b, 1, f]), bool(out[b, 2, f] > 0.5)
        one = dict(c, rows=c["rows"][b:b + 1], scal=c["scal"][b:b + 1])
        g = _gains(one, int(f))
        lanes = torch.nonzero(g[use_f] == float("inf")).flatten()
        assert len(lanes) and t == int(lanes.min() if use_f
                                       else lanes.max())
        if use_f:                        # forward only on a greater gain
            assert (g[False] < float("inf")).all()
        checked += 1
    assert checked


def _gains(c, f):
    """{forward: [Wp] gains, reverse: [Wp]} of feature f for a one-child
    pair_case, from the plain version's formulas (NaN and invalid lanes as
    -inf)."""
    scal, gb, hb, keep_r, keep_f, valid_r, valid_f, _ = pair_gathered(c)
    s = scal[0]
    sg, sh, nd, cf, md, mh, mgs, l2 = (s[i] for i in range(8))
    g, h = gb[0, f], hb[0, f]
    cnt = torch.floor(h * cf + 0.5)
    out = {}
    for fwd, keep, valid in ((False, keep_r[f], valid_r[f]),
                             (True, keep_f[f], valid_f[f])):
        pg = _prefix((g * keep)[None, None])[0, 0]
        ph = _prefix((h * keep)[None, None])[0, 0]
        pc = _prefix((cnt * keep)[None, None])[0, 0]
        if fwd:
            lg, lh, lc = pg, ph, pc
            rg, rh, rc = sg - pg, sh - ph, nd - pc
        else:
            rg, rh, rc = pg[-1] - pg, ph[-1] - ph, pc[-1] - pc
            lg, lh, lc = sg - rg, sh - rh, nd - rc
        gain = lg * lg / (lh + l2) + rg * rg / (rh + l2)
        ok = (valid > 0) & (lc >= md) & (lh >= mh) & (rc >= md) & \
            (rh >= mh) & (gain > mgs)
        out[fwd] = torch.where(ok, gain, float("-inf"))
    return out


def test_scan_blocks_plain_inf_times_zero_penalty_has_no_split():
    """In the block scan the penalty multiplies before the choice: an inf
    gain times a zero penalty is NaN, the plain version's maximum is then
    NaN and no lane equals it, so that direction has no split in that
    group; with the penalties restored the same inputs split there."""
    kw = dict(l2=0.0, min_data=0, min_hess=0.0, zero_hess=0.3)
    c0 = block_case(6, 16, 256, zero_pen=True, **kw)
    c1 = block_case(6, 16, 256, **kw)
    o0 = bs.scan_blocks(c0["scal"], c0["gh"], c0["hh"], c0["masks"],
                        c0["do_fix"], rows=c0["rows"], groups=c0["G"])
    o1 = bs.scan_blocks(c1["scal"], c1["gh"], c1["hh"], c1["masks"],
                        c1["do_fix"], rows=c1["rows"], groups=c1["G"])
    inf = o1[:, 0, :c1["G"]] == float("inf")
    assert inf.any()
    for b, g in zip(*torch.nonzero(inf, as_tuple=True)):
        # the direction that took the inf gain has none with a zero penalty
        assert o0[b, 6, g] == 0 or o0[b, 2, g] != o1[b, 2, g]
        if o0[b, 6, g] > 0:
            assert o0[b, 0, g] == 0      # a finite gain times 0
