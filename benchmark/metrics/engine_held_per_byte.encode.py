"""engine_held_per_byte.encode: per encode call of the entry's held-memory
pass (`host_phases`, after the traced window), the most device memory
the call held beyond what was held at its entry (its peak, from the
allocator's events under the profiler, less its bytes at entry), over
the object's bytes; the mean over the calls, in bytes a byte. None where
the pass gave no reading. Prints on stderr the program span innermost
at the calls' highest peak, with the readings.

`held_per_byte` is the arithmetic of both directions' readers; the
decode's loads it from here."""

import sys


def held_per_byte(run, role: str):
    t = run.trace
    calls = [c for c in (t.host_phases if t is not None else [])
             if isinstance(c, dict) and c.get("role") == role]
    if not calls:
        return None
    per = [(c["peak_bytes"] - c["entry_bytes"]) / c["bytes"] for c in calls]
    top = max(calls, key=lambda c: c["peak_bytes"])
    print(f"[bench] engine_held_per_byte.{role} {sum(per) / len(per):.6f} "
          f"B/B over {len(calls)} calls (each {per}); entry "
          f"{[c['entry_bytes'] for c in calls]} B, peak "
          f"{[c['peak_bytes'] for c in calls]} B; the step that held the "
          f"most: {top['peak_step']} {top['peak_bytes']} B; the most each "
          f"step held in the last call {calls[-1]['steps']}",
          file=sys.stderr, flush=True)
    return sum(per) / len(per)


def read(run):
    return held_per_byte(run, "encode")
