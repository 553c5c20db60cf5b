"""The byte and operation counts, against hand-computed values at a small
shape."""

from benchmark.counts import kernels as k


def test_fan_bytes():
    # B=2, NRC=3, W=5, LP=7: 4 * (18*30 + 30 + 60 + 126 + 65 + 2)
    assert k.fan_bytes(2, 3, 5, 7) == 4 * (540 + 30 + 60 + 126 + 65 + 2)
    assert k.fan_ops(2, 3, 5) == 540


def test_chain_bytes():
    # one bucket without variants: B=2, NST=3, D=4, W=5
    plain = 16 * 2 * 3 * 20 + 4 * 12 * 20 + 20 + 4 * 2 * (180 + 15 + 15)
    assert k.chain_bytes(2, 3, [(4, 5, 0, 0)]) == plain
    # with first-phone variants RF=2, NFD=6: VAR, prevd, fd_idx and nv
    var = plain + 4 * 2 * 3 * 5 + 4 * 2 * 3 * 2 * 6 + 8 * 5
    assert k.chain_bytes(2, 3, [(4, 5, 2, 6)]) == var
    assert k.chain_ops(2, 3, [(4, 5, 0, 0), (1, 1, 0, 0)]) == 12 * 6 * 21


def test_transitions_and_scoring():
    assert k.transitions_bytes(2, 10, 3, 4) == 128 + 96 + 260 + 800
    # PTM en-us per row: 4*3*13*42*128 + 2*3*128*5126
    assert k.scoring_flops(1, 42, 3, 128, 13, 5126) == 838656 + 3936768


def test_bounds():
    assert k.bound_s(3.35e12, 0) == 1.0
    assert k.bound_s(0, 67e12) == 1.0
    shapes = dict(NRC=3, W=5, LP=7, NST=3, nE=10, K=4,
                  buckets=[(4, 5, 0, 0)])
    c = k.step_counts(shapes, 2, dict(n_cb=42, n_feat=3, n_density=128,
                                      dim=13, n_sen=5126))
    want = (c["scoring_flops"] / 67e12 + (c["fan_bytes"] + c["chain_bytes"]
            + c["transitions_bytes"]) / 3.35e12)
    assert abs(c["step_s"] - want) < 1e-18
    assert c["fan_s"] == k.fan_bytes(2, 3, 5, 7) / 3.35e12
