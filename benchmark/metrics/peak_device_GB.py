"""peak_device_GB: torch.cuda.max_memory_allocated() over the window,
reset at its start, in 1e9 bytes: the card memory the codec takes from
its user, the staged pool of a device-resident cell included."""


def read(run):
    if run.trace is not None or not run.peak_bytes:
        return None
    return run.peak_bytes / 1e9
