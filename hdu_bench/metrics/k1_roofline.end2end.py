"""K1's share of its roofline in the end-to-end stage's training step: the
least time of one step's frozen 2D BN-Scale-ReLUs, forward and backward
(``work/train_hybrid.k1_bound_s``: the reference's 2D forward at the step's
slices, recomputation not counted), over the device seconds of K1's kernels
(names holding ``affine_relu``, K5's ``affine_gemm`` not among them) per
traced step. Runs without ``k1_bound_s`` (the 2D stage's) read nothing."""
UNIT = "%"
MOVES = "train_ms_per_step.graphed"


def read(run):
    bound = run.get("work", {}).get("k1_bound_s")
    if MOVES not in run.get("metrics", {}) or "trace" not in run or bound is None:
        return None
    k1 = sum(s for name, s in run["trace"]["device_ops"].items() if "affine_relu" in name)
    if k1 <= 0.0:
        return None
    return 100.0 * bound / (k1 / run["traced_units"])
