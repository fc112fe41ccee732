"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over set-up and
window, read by the harness from the allocator on the host, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.device.type == "cuda" else None
