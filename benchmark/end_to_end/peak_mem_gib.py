"""peak_mem_gib: the most device memory the process held, reserved by the
caching allocator over set-up and window (``torch.cuda.max_memory_reserved``),
the solves' CUDA-graph capture pool included, in GiB."""


def read(record):
    peak = record["memory_reserved_peak_bytes"]
    return peak / 2**30 if peak is not None else None
