"""peak_mem_gb: torch.cuda.max_memory_allocated over the window (reset at
its start), in GB (1e9 bytes)."""


def read(win):
    return win.peak_bytes / 1e9 if win.peak_bytes else None
