"""K5's share of its roofline: the summed bound of one volume's dense-block
1x1 chains (``work/counts.serve_volume``: the configuration's widths over
the distinct stacks and windows) over the device seconds of K5's kernels
(names holding ``affine_gemm``) per traced volume."""
UNIT = "%"
MOVES = "serve_s_per_volume"


def read(run):
    bound = run.get("work", {}).get("k5_bound_s")
    if MOVES not in run.get("metrics", {}) or "trace" not in run or bound is None:
        return None
    k5 = sum(s for name, s in run["trace"]["device_ops"].items() if "affine_gemm" in name)
    if k5 <= 0.0:
        return None
    return 100.0 * bound / (k5 / run["traced_units"])
