"""Kernel B (the greedy symbol loop): the least time of the work the traced
reps' inputs need, each lane's post-stack frames plus its emitted symbols
(not the iterations launched), at the costs the cell's model gives
(``decode_costs``), over the kernel's time in the trace."""

from benchmark import roofline


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.kernel_s(roofline.KERNEL_NAME["kernel_b"])
    launches = run.launches.get("decode_step", 0)
    if not busy or not launches or not run.work:
        return None
    w, k = run.work, run.cell.model.decode_costs(run.cell.config)
    least = roofline.kernel_b(w["post_frames"] + w["symbols"], w["post_frames"], launches,
                              k["iteration_ops"], k["weight_bytes"], k["frame_bytes"],
                              k["precision"])
    return 100.0 * least / busy
