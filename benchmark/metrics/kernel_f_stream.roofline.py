"""Kernel F's streaming form (csrc/rel_attention.cu rel_attention_stream, the
streaming FastConformer's chunked-limited attention): the least time of the
traced calls over the kernel's time in the trace.  The calls are the
program's own record (utils/profiler.py ``REGISTRY.calls``, kept while the
profile ran): per call each slot's chunk index and encoder length.  A slot
and head take 6 q k d operations (q the chunk's rows inside the utterance,
k the rows of its last R chunks inside it) at the bf16 peak, against q, the
seen K and V rows and the output read or written once (bf16) and the
position band once a call (the model module counts them).  Silent unless
the calls of the last profile are as many as the kernel's launches in the
trace (a program without the streaming form records none)."""

NAME = "rel_attention_stream"  # the kernel's name in the device trace


def read(run):
    model = run.cell.model
    if run.trace is None or not hasattr(model, "stream_f_least"):
        return None
    calls = model.profiled_calls("kernel_f_stream")
    n, busy = model.traced_kernel(run.trace, NAME)
    if not busy or not calls or len(calls) != n:
        return None
    return 100.0 * model.stream_f_least(calls) / busy
