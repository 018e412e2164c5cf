"""Kernel G's causal form (csrc/depthwise.cu depthwise_causal, the streaming
FastConformer's depthwise convolution with its cache, LayerNorm and Swish):
the least time of the traced calls over the kernel's time in the trace.
The calls are the program's own record (utils/profiler.py
``REGISTRY.calls``, kept while the profile ran).  A call reads its rows, the
slots' cache rows and the taps, and writes its rows and the cache rows,
each once (bf16); its 2 K operations an element lie far under the ridge, so
the bytes at HBM bandwidth bound it (the model module counts them).  Silent
unless the calls of the last profile are as many as the kernel's launches
in the trace."""

NAME = "depthwise_causal"  # the kernel's name in the device trace


def read(run):
    model = run.cell.model
    if run.trace is None or not hasattr(model, "stream_g_least"):
        return None
    calls = model.profiled_calls("kernel_g_causal")
    n, busy = model.traced_kernel(run.trace, NAME)
    if not busy or not calls or len(calls) != n:
        return None
    return 100.0 * model.stream_g_least(calls) / busy
