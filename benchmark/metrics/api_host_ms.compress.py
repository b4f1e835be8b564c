"""api_host_ms.compress: per compress call, the milliseconds of the host
work alone that the program's own `MHC_TRACE` report times without a
device sync: `blockify` + `crc32` + `container`, averaged over the calls
the entry traced after the profiled window."""

PHASES = ("blockify", "crc32", "container")


def read(run):
    reports = run.trace.host_phases if run.trace is not None else []
    if not reports:
        return None
    ms = [1e3 * sum(r.get(p, {}).get("seconds", 0.0) for p in PHASES)
          for r in reports]
    return sum(ms) / len(ms)
