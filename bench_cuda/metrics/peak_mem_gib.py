"""Peak device memory the allocator handed out in the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), on
the fullest card, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
