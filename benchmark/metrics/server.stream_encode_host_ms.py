"""The host's ms per streaming-encoder enqueue (a Server step's
rnnt.server.stream_encode span: the window, the subsampling and every
block of the streaming FastConformer): the mean of the spans that began
between 1 s and trace_from_s - 0.5 s into the last run_server_native call,
the stretch server.extract_host_ms reads."""


def read(run):
    try:
        from rnnt_inference_tpu_torch.utils.profiler import REGISTRY
    except ImportError:  # a program without the span registry
        return None
    rec, stats = REGISTRY.server, REGISTRY.spans.get("rnnt.server.stream_encode")
    if rec is None or stats is None:
        return None
    lo = rec.start_ns + 1e9
    hi = rec.start_ns + (run.cell.traffic["trace_from_s"] - 0.5) * 1e9
    calls = [end - start for start, end in stats.intervals(lo, hi)]
    return sum(calls) / len(calls) / 1e6 if calls else None
