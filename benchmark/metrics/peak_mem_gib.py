"""peak_mem_gib: the program's peak of device memory over set-up and the
window (torch.cuda.max_memory_allocated), in GiB, without the copy of
the post-set-up state that the benchmark keeps to start the simulation
again from."""


def read(ctx):
    return ctx.program_peak_bytes / 2 ** 30 if ctx.program_peak_bytes else None
