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
import pytest

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
