"""The launch plans of the port's two int8 tensor-core kernels, on the CPU.

``int8_conv`` (K3) picks a route by shape (:func:`int8_conv_route`) and,
on its ``hopper`` route, a tile shape and a depth split
(:func:`int8_conv_plan`); ``int8_linear``'s tensor-core route splits K
over the CTAs of a cluster (:func:`int8_linear_plan`).  The kernels
themselves run only on the card; here every output tile, and every
depth stage of it, must be covered by exactly one CTA of the plan (the
``*_blocks`` helpers walk the CTAs with the kernels' index math), and
each plan must stay inside what its kernel takes.  No JAX.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import int8 as i8

# ResNet-50 v1 at B=32, 224^2 (the layout of model_zoo's resnet50_v1: the
# stride on each stage's first 3 x 3): (name, N, C, H, W, O, k, s, p);
# the Dense last, as the 1 x 1 convolution of (32, 2048)
B = 32


def _resnet50_layers():
    layers = [("stem", B, 3, 224, 224, 64, 7, 2, 3)]
    size, cin = 56, 64
    for stage, (blocks, cout) in enumerate(((3, 256), (4, 512), (6, 1024),
                                            (3, 2048))):
        mid = cout // 4
        for blk in range(blocks):
            s = 2 if stage and blk == 0 else 1
            out = size // s
            tag = "s%d b%d" % (stage + 1, blk + 1)
            layers += [(tag + " conv1", B, cin, size, size, mid, 1, 1, 0),
                       (tag + " conv2", B, mid, size, size, mid, 3, s, 1),
                       (tag + " conv3", B, mid, out, out, cout, 1, 1, 0)]
            if blk == 0:
                layers.append((tag + " down", B, cin, size, size, cout, 1, s,
                               0))
            size, cin = out, cout
    layers.append(("dense", B, 2048, 1, 1, 1000, 1, 1, 0))
    return layers


RESNET50 = _resnet50_layers()
# chip_smoke.INT8_CONV_EDGES and the card tests' hopper cases: (N, C, H,
# W, O, kernel, stride, pad, dilation, groups)
EDGES = [(2, 3, 31, 29, 64, 7, 2, 3, 1, 1), (1, 37, 13, 11, 45, 3, 2, 0, 2, 1),
         (3, 24, 9, 9, 40, 3, 1, 1, 1, 2), (2, 32, 9, 9, 32, 3, 2, 1, 1, 32),
         (2, 100, 10, 10, 70, 1, 1, 0, 1, 1),
         (2, 64, 12, 10, 64, 3, 1, 1, 1, 1),
         (2, 128, 11, 13, 96, 3, 2, 2, 2, 1),
         (4, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
         (1, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
         (17, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
         (33, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
         (3, 96, 9, 7, 70, 3, 2, 1, 1, 1), (2, 512, 7, 7, 512, 3, 1, 1, 1, 1)]


def _geometry(N, C, H, W, O, k, s, p, d=1, g=1):
    cgp = i8.padded_channels(C // g)
    OH = (H + 2 * p - d * (k - 1) - 1) // s + 1
    OW = (W + 2 * p - d * (k - 1) - 1) // s + 1
    kp = -(-k * k * cgp // i8.CONV_BK) * i8.CONV_BK
    return cgp, N * OH * OW, kp


def _assert_partition(spans, total):
    """``spans`` (start, stop) tile [0, total) with no gap or overlap."""
    at = 0
    for a, b in sorted(set(spans)):
        assert a == at and b > a, (sorted(set(spans)), total)
        at = b
    assert at == total


def _assert_covers(blocks, M, O, kt, splits):
    """Every (row tile, column tile) pair is one tile of the plan, and
    ``splits`` CTAs take each of its depth stages once, none of them
    idle."""
    tiles = {}
    for m0, m1, o0, o1, k0, k1 in blocks:
        assert m1 > m0 and o1 > o0
        tiles.setdefault((m0, m1, o0, o1), []).append((k0, k1))
    _assert_partition([t[:2] for t in tiles], M)
    _assert_partition([t[2:] for t in tiles], O)
    assert len(tiles) == len({t[:2] for t in tiles}) * len(
        {t[2:] for t in tiles})
    for ranges in tiles.values():
        assert len(ranges) == splits
        _assert_partition(ranges, kt)


def _conv_plan_ok(N, H, W, cgp, M, O, kp):
    plan = i8.int8_conv_plan(M, O, kp)
    nwg, n, swap, _ = i8.HOPPER_CFGS[plan["cfg"]]
    S = plan["splits"]
    assert S in (1, 2, 4, 8) and S <= plan["kt"]
    # the epilogue's slice of 64 * nwg / S rows holds whole 16-byte runs
    assert (64 * nwg // S) % 8 == 0 and n % 8 == 0
    assert swap == (M <= 64)
    tiles = plan["m_tiles"] * plan["o_tiles"]
    # split: one tile a cluster; unsplit: persistent CTAs, as many as the
    # card holds at once (HOPPER_CFGS' CTAs an SM), none without a tile
    if S > 1:
        assert plan["ctas"] == tiles * S
    else:
        assert plan["ctas"] == min(tiles, i8.SMS * i8.HOPPER_CFGS[
            plan["cfg"]][3])
    _assert_covers(list(i8.int8_conv_blocks(plan, M, O)), M, O, plan["kt"],
                   S)
    return plan


def test_resnet50_routes_52_convolutions_and_the_dense_to_hopper():
    routes = {}
    for name, N, C, H, W, O, k, s, p in RESNET50:
        cgp, M, kp = _geometry(N, C, H, W, O, k, s, p)
        routes[name] = i8.int8_conv_route(N, H, W, cgp, 1)
    assert len(routes) == 54
    assert [n for n, r in routes.items() if r == "general"] == ["stem"]
    assert sum(r == "hopper" for r in routes.values()) == 53


@pytest.mark.parametrize("layer", RESNET50, ids=[lay[0] for lay in RESNET50])
def test_int8_conv_plan_covers_resnet50(layer):
    name, N, C, H, W, O, k, s, p = layer
    cgp, M, kp = _geometry(N, C, H, W, O, k, s, p)
    if i8.int8_conv_route(N, H, W, cgp, 1) == "hopper":
        plan = _conv_plan_ok(N, H, W, cgp, M, O, kp)
        # a stage of 128 bytes: a 64-multiple weight row ends in a half
        assert plan["kt"] == -(-kp // i8.HOPPER_BK)


@pytest.mark.parametrize("edge", EDGES)
def test_int8_conv_route_and_plan_at_the_edges(edge):
    N, C, H, W, O, k, s, p, d, g = edge
    cgp, M, kp = _geometry(N, C, H, W, O, k, s, p, d, g)
    route = i8.int8_conv_route(N, H, W, cgp, g)
    assert route == ("hopper" if g == 1 and cgp % 32 == 0 else "general")
    if route == "hopper":
        _conv_plan_ok(N, H, W, cgp, M, O, kp)


def test_int8_conv_plan_splits_the_small_grids():
    # the 7^2 stage's 3 x 3 (104 tiles on 132 SMs) and the Dense at M = 32
    # (16 tiles of 64 channels, operands swapped) split their depth
    _, M, kp = _geometry(32, 512, 7, 7, 512, 3, 1, 1)
    assert i8.int8_conv_plan(M, 512, kp)["splits"] == 2
    dense = i8.int8_conv_plan(32, 1000, 2048)
    assert dense["swap"] and dense["splits"] == 8
    assert dense["o_tiles"] * dense["splits"] == 128
    # 56^2: 784 tiles, no split: 264 persistent CTAs, 2 an SM
    _, M, kp = _geometry(32, 64, 56, 56, 64, 3, 1, 1)
    plan = i8.int8_conv_plan(M, 64, kp)
    assert plan["splits"] == 1 and plan["ctas"] == 264


def test_int8_conv_route_refuses_huge_inputs():
    assert i8.int8_conv_route(1024, 224, 224, 64, 1) == "general"
    assert i8.int8_conv_route(1, 7, 7, 48, 1) == "general"


# the decode's products at Llama-3-8B width, (K, N); their rank-local
# blocks under tp = 2 and 4 (wq, wk, wv, w1, w3 split by rows of the
# weight, wo and w2 by columns, the head by rows); odd N and K
DECODE = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
          (4096, 128256)]
LOCAL = sorted({(K // (tp if row else 1), N // (1 if row else tp))
                for tp in (2, 4)
                for K, N, row in ((4096, 4096, False), (4096, 1024, False),
                                  (4096, 14336, False), (14336, 4096, True),
                                  (4096, 4096, True), (4096, 128256, False))})
ODD = [(4099, 1001), (528, 64), (4096, 33), (16, 9)]


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("shape", DECODE + LOCAL + ODD,
                         ids=["K%d-N%d" % s for s in DECODE + LOCAL + ODD])
def test_int8_linear_plan_covers(shape, M):
    K, N = shape
    plan = i8.int8_linear_plan(M, N, K)
    S = plan["splits"]
    assert S in (1, 2, 4, 8) and S <= plan["kt"]
    assert plan["kt"] == -(-K // i8.LINEAR_BK)
    assert i8.LINEAR_ROWS % S == 0 and plan["m_tiles"] <= 65535
    _assert_covers(list(i8.int8_linear_blocks(plan, M, N)), M, N,
                   plan["kt"], S)


def test_int8_linear_plan_fills_the_card_at_the_decode_shapes():
    # every decode shape at M = 8 launches at least 128 CTAs, the narrow
    # ones by splitting K; the head needs no split
    for K, N in DECODE:
        plan = i8.int8_linear_plan(8, N, K)
        assert plan["n_tiles"] * plan["splits"] >= 128, (K, N, plan)
    assert i8.int8_linear_plan(8, 1024, 4096)["splits"] == 8
    assert i8.int8_linear_plan(8, 128256, 4096)["splits"] == 1


# ---------------------------------------------------------------------------
# K2 (int8_quantize): which layout each convolution's input takes, the tile
# plan, and the tile and im2col kernels' index math emulated in numpy
# ---------------------------------------------------------------------------

def _modes(layers):
    return {name: i8.int8_conv_mode(N, C, H, W, (k, k), (s, s), (p, p))
            for name, N, C, H, W, O, k, s, p in layers}


def test_int8_conv_mode_sends_all_54_resnet50_inputs_to_hopper():
    modes = _modes(RESNET50)
    assert len(modes) == 54
    assert set(r for _, r in modes.values()) == {"hopper"}
    assert [n for n, (m, _) in modes.items() if m == "im2col"] == ["stem"]


@pytest.mark.parametrize("edge", EDGES)
def test_int8_conv_mode_at_the_edges(edge):
    N, C, H, W, O, k, s, p, d, g = edge
    mode, route = i8.int8_conv_mode(N, C, H, W, (k, k), (s, s), (p, p),
                                    (d, d), g)
    cgp = i8.padded_channels(C // g)
    if g > 1 and C == g:             # depthwise: its own route
        assert (mode, route) == ("nhwc", "depthwise")
    elif g > 1:                      # grouped stays general
        assert (mode, route) == ("nhwc", "general")
    elif cgp % 32:                   # the stem, odd channel counts
        assert (mode, route) == ("im2col", "hopper")
    else:
        assert (mode, route) == ("nhwc", "hopper")


def test_int8_conv_mode_keeps_inputs_without_im2col_rows_general():
    # a depth past IM2COL_MAX_K (11 x 11 x 20 channels) and int offsets
    assert i8.int8_conv_mode(2, 20, 32, 32, (11, 11)) == ("nhwc", "general")
    assert i8.int8_conv_mode(4096, 3, 512, 512, (3, 3)) == \
        ("nhwc", "general")


def test_the_stems_im2col_rows_plan_as_a_1x1_hopper_convolution():
    geo = i8._col_geometry((32, 3, 224, 224), (7, 7), (2, 2),
                           (3, 3), (1, 1))
    N, OH, OW, kc = geo[0], geo[13], geo[14], geo[15]
    assert (OH, OW, kc) == (112, 112, 224)
    kp = i8.pack_conv_weight(torch.zeros(64, 3, 7, 7, dtype=torch.int8),
                             1).shape[2]
    assert kp == 256 and kc <= kp
    assert i8.int8_conv_route(N, OH, OW, kc, 1) == "hopper"
    _conv_plan_ok(N, OH, OW, kc, N * OH * OW, 64, kp)


def _quantize_inputs(layers):
    """The distinct (N, C, P) a forward quantizes on the NHWC layout."""
    shapes = []
    for name, N, C, H, W, O, k, s, p in layers:
        if _modes([(name, N, C, H, W, O, k, s, p)])[name][0] == "nhwc":
            shapes.append((N, C, H * W))
    return sorted(set(shapes))


def test_int8_quantize_plan_at_resnet50_inputs():
    shapes = _quantize_inputs(RESNET50)
    assert len(shapes) == 12          # 11 feature maps and the Dense
    for N, C, P in shapes:
        plan = i8.int8_quantize_plan(N, C, P)
        if P == 1:
            assert plan["kind"] == "rows" and plan["tcb"] == 0
            assert plan["ctas"] == N * C // 4 // i8.QUANT_THREADS
            continue
        # channel counts of 64 and more: whole 64-byte rows or 128-byte
        # lines of each position, 8 KB a tile
        assert plan["tcb"] == (64 if C == 64 else 128)
        assert plan["positions"] * plan["tcb"] == i8.QUANT_TILE
        assert plan["ctiles"] * plan["tcb"] == C
        assert (plan["ptiles"] - 1) * plan["positions"] < P <= \
            plan["ptiles"] * plan["positions"]
        # a CTA an SM or more: 512 x 7^2 has the fewest, 4 x 32 = 128
        assert plan["ctas"] >= 128


@pytest.mark.parametrize("ctot,tcb", [(4, 0), (12, 0), (16, 16), (20, 32),
                                      (32, 32), (40, 64), (64, 64),
                                      (68, 128), (128, 128), (200, 128),
                                      (4096, 128)])
def test_int8_quantize_plan_tile_width(ctot, tcb):
    plan = i8.int8_quantize_plan(3, ctot, 10)
    assert plan["tcb"] == tcb
    if tcb:                # rows under 16 bytes: a 4-byte word a thread
        assert plan["kind"] == "tile" and plan["ctiles"] == -(-ctot // tcb)
    else:
        assert plan["kind"] == "rows" and plan["ctas"] == 1


THREADS = i8.QUANT_THREADS


def _emulate_tile(qv, groups, plan):
    """quantize_tile's index math over already-quantized values ``qv``
    (N, C, P): each CTA's shared-memory writes (unit -> 4 swizzled
    words) and reads (a 16-byte chunk a thread) and its stores, as the
    kernel computes them.  Asserts that every output byte is written
    once and that no warp's writes, nor a quarter warp's reads, meet a
    bank twice; returns the output (N, P, Ctot)."""
    N, C, P = qv.shape
    cg = C // groups
    cgp = i8.padded_channels(cg)
    ctot = groups * cgp
    tcb = plan["tcb"]
    tp, rpl, cpr = i8.QUANT_TILE // tcb, 128 // tcb, tcb // 16
    per = i8.QUANT_TILE // 16 // THREADS
    out = onp.full((N, P, ctot), 999, onp.int64)
    tid = onp.arange(THREADS)
    lane = tid & 31
    for n in range(N):
        for pt in range(plan["ptiles"]):
            for ct in range(plan["ctiles"]):
                p0, c0 = pt * tp, ct * tcb
                tile = onp.zeros(i8.QUANT_TILE, onp.int64)
                for k in range(per):
                    wu = (tid >> 5) + k * (THREADS // 32)
                    cq = (wu % cpr) * 4 + (lane >> 3)
                    pq = (wu // cpr) * 8 + (lane & 7)
                    for i in range(4):
                        row = 4 * pq + i
                        h = (row % rpl) * cpr + (cq >> 2)
                        word = (row // rpl) * 32 + ((h ^ (pq & 7)) << 2) + \
                            (cq & 3)
                        for w in range(THREADS // 32):   # a warp's banks
                            assert len(set(word[32 * w:32 * w + 32] % 32)) \
                                == 32
                        p = onp.minimum(p0 + row, P - 1)
                        for j in range(4):
                            oc = c0 + 4 * cq + j
                            grp, cl = oc // cgp, oc % cgp
                            ok = (oc < ctot) & (cl < cg)
                            src = onp.where(ok, grp * cg + cl, 0)
                            tile[word * 4 + j] = onp.where(
                                ok, qv[n, src, p], 0)
                for k in range(per):
                    t = tid + k * THREADS
                    line, h = t >> 3, t & 7
                    row = line * rpl + h // cpr
                    chunk = line * 8 + (h ^ ((row >> 2) & 7))
                    for qw in range(THREADS // 8):       # a quarter's banks
                        assert len(set(chunk[8 * qw:8 * qw + 8] % 8)) == 8
                    for tt in range(THREADS):
                        oc = c0 + (h[tt] % cpr) * 16
                        p = p0 + row[tt]
                        if p >= P or oc >= ctot:
                            continue
                        nb = min(16, ctot - oc)
                        assert (out[n, p, oc:oc + nb] == 999).all()
                        out[n, p, oc:oc + nb] = tile[16 * chunk[tt]:
                                                     16 * chunk[tt] + nb]
    assert (out != 999).all()
    return out


@pytest.mark.parametrize("N,C,P,groups", [
    (2, 64, 50, 1),        # whole 64-byte rows, P % 4 != 0
    (1, 256, 70, 1),       # two 128-byte lines a row, a ragged last tile
    (1, 200, 9, 1),        # 200 channels: a 128-byte line and 72 bytes
    (2, 16, 13, 1),        # whole 16-byte rows
    (1, 24, 11, 3),        # groups of 8 channels
    (1, 37, 6, 1),         # 37 -> 40: 64-byte tiles, words at the end
    (1, 24, 5, 2),         # groups of 12 padded to 12, 32-byte tiles
])
def test_quantize_tile_index_math_against_plain(N, C, P, groups):
    rs = onp.random.RandomState(C + P)
    qv = rs.randint(-128, 128, (N, C, P)).astype(onp.int8)
    plan = i8.int8_quantize_plan(N, C, P, groups)
    assert plan["kind"] == "tile"
    got = _emulate_tile(qv.astype(onp.int64), groups, plan)
    want = i8.int8_quantize_plain(torch.from_numpy(qv), 1.0, groups)
    onp.testing.assert_array_equal(got, want.reshape(N, P, -1).numpy())


def _emulate_im2col(qv, geo, plan):
    """quantize_im2col's index math over already-quantized ``qv`` (N, C,
    H, W), as the kernel computes it: each CTA's patch ([row][column]
    [Cgp], zeros outside the image and in the padded channels) and depth
    word table, then each 16-byte chunk of its rows, 4 words read from
    the patch; every chunk written once.  (N * OH * OW, Kc)."""
    N, C, H, W, cgp, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, kc = geo
    th, tw = plan["th"], plan["tw"]
    PH, PW = (th - 1) * sh + (kh - 1) * dh + 1, (tw - 1) * sw + (kw - 1) * \
        dw + 1
    assert PH * PW * cgp == plan["patch"] <= i8.IM2COL_PATCH
    k = 4 * onp.arange(kc // 4)
    tap = k // cgp
    word_off = onp.where(k < kh * kw * cgp,
                         ((tap // kw) * dh * PW + (tap % kw) * dw) * cgp
                         + k % cgp, -1)
    out = onp.full((N * OH * OW, kc), 999, onp.int64)
    twn, thn = -(-OW // tw), -(-OH // th)
    assert plan["ctas"] == N * twn * thn
    for b in range(plan["ctas"]):
        t_w, rest = b % twn, b // twn
        t_h, n = rest % thn, rest // thn
        oh0, ow0 = t_h * th, t_w * tw
        ih, iw = oh0 * sh - ph + onp.arange(PH), ow0 * sw - pw + \
            onp.arange(PW)
        patch = onp.zeros((PH, PW, cgp), onp.int64)
        inside = ((ih >= 0) & (ih < H))[:, None] & ((iw >= 0) & (iw < W))
        for c in range(C):
            patch[:, :, c] = onp.where(inside, qv[n, c][onp.clip(
                ih, 0, H - 1)][:, onp.clip(iw, 0, W - 1)], 0)
        flat = patch.reshape(-1)
        for lr in range(th):
            for lc in range(tw):
                if oh0 + lr >= OH or ow0 + lc >= OW:
                    continue
                base = (lr * sh * PW + lc * sw) * cgp
                m = (n * OH + oh0 + lr) * OW + ow0 + lc
                assert (out[m] == 999).all()
                idx = base + word_off[:, None] + onp.arange(4)
                out[m] = onp.where(word_off[:, None] >= 0,
                                   flat[onp.where(word_off[:, None] >= 0,
                                                  idx, 0)], 0).reshape(-1)
    assert (out != 999).all()
    return out


@pytest.mark.parametrize("shape,k,s,p,d", [
    ((2, 3, 15, 13), 7, 2, 3, 1),     # the stem's geometry, small
    ((1, 5, 9, 10), 3, 1, 2, 2),      # dilation, 5 -> 8 channels
    ((2, 12, 6, 7), 3, 2, 1, 1),      # 12 channels: 108 -> 128 of depth
    ((1, 4, 8, 8), 1, 1, 0, 1),       # a 1 x 1: 4 -> 32
    ((1, 3, 5, 1600), 7, 1, 3, 1),    # a wide row: two shares of it
])
def test_quantize_im2col_index_math_against_plain(shape, k, s, p, d):
    qv = onp.random.RandomState(k * 7 + p).randint(-128, 128, shape) \
        .astype(onp.int8)
    x = torch.from_numpy(qv)
    geo = i8._col_geometry(x.shape, (k, k), (s, s), (p, p), (d, d))
    want = i8.int8_quantize_im2col_plain(x, 1.0, (k, k), (s, s), (p, p),
                                         (d, d))
    assert want.shape == (shape[0], geo[13], geo[14], geo[15])
    assert geo[15] % 32 == 0 and geo[15] >= k * k * geo[4]
    plan = i8.int8_im2col_plan(geo)
    onp.testing.assert_array_equal(_emulate_im2col(qv.astype(onp.int64),
                                                   geo, plan),
                                   want.reshape(-1, geo[15]).numpy())


def test_int8_im2col_plan_at_the_stem_and_its_limits():
    geo = i8._col_geometry((32, 3, 224, 224), (7, 7), (2, 2), (3, 3),
                           (1, 1))
    plan = i8.int8_im2col_plan(geo)
    # whole output rows of 112, 8 of them: a 21 x 229 x 4 patch
    assert plan == {"th": 8, "tw": 112, "patch": 21 * 229 * 4,
                    "ctas": 32 * 14}
    # a wide image halves the share of a row; a patch past the limit of
    # one position has no plan
    wide = i8._col_geometry((1, 3, 8, 4000), (7, 7), (1, 1),
                            (3, 3), (1, 1))
    plan = i8.int8_im2col_plan(wide)
    assert plan["tw"] < 4000 and plan["patch"] <= i8.IM2COL_PATCH
    big = i8._col_geometry((1, 60, 99, 99), (31, 31), (1, 1),
                           (0, 0), (1, 1))
    assert i8.int8_im2col_plan(big) is None


@pytest.mark.parametrize("kc,th,tw", [(224, 4, 112), (32, 2, 1), (2048, 5, 3),
                                      (64, 9, 7), (96, 16, 16)])
def test_im2col_chunk_walk_covers_each_chunk_once(kc, th, tw):
    """quantize_im2col's walk of a tile's (row, chunk) pairs: each thread
    starts at its index and steps QNT chunks with carries (a division
    only where a row of positions wraps), as the kernel does; every pair
    is visited once, with (lr, lc) the row's place in the tile."""
    cw, rows = kc // 16, th * tw
    drow, dch = THREADS // cw, THREADS % cw
    seen = set()
    for tid in range(THREADS):
        row, ch = tid // cw, tid % cw
        lr, lc = row // tw, row % tw
        while row < rows:
            assert (lr, lc) == divmod(row, tw)
            assert (row, ch) not in seen
            seen.add((row, ch))
            adv = drow
            ch += dch
            if ch >= cw:
                ch -= cw
                adv += 1
            row += adv
            lc += adv
            if lc >= tw:
                lr += lc // tw
                lc -= (lc // tw) * tw
    assert len(seen) == rows * cw
