"""Run a Python script under a stack sampler of its main thread, to find
where a host-bound run spends its time.

    python3 chip_sample.py OUT.json SCRIPT.py [ARGS...]

Every PERIOD seconds a thread reads the main thread's stack and counts, for
each sample, every (file, line, function) on it once (inclusive time) and
the innermost frame (self time); the samples' mean interval turns counts
into seconds.  Time in C code that holds the interpreter's lock delays the
sampler, so the figures are approximate shares, not timings.  OUT.json holds
the sample count, the wall seconds and the largest counters; the script's
exit code is the sampled script's.  Only the main thread of this process
is sampled, not the processes a script starts.
"""

import collections
import json
import os
import runpy
import sys
import threading
import time

PERIOD = 0.005


def main() -> int:
    out_path, script = sys.argv[1], sys.argv[2]
    sys.argv = sys.argv[2:]
    main_id = threading.get_ident()
    lines = collections.Counter()  # (file, line, function), inclusive
    funcs = collections.Counter()  # (file, function), inclusive
    leaves = collections.Counter()  # (file, function), innermost frame
    samples = 0
    stop = threading.Event()

    def sample():
        nonlocal samples
        while not stop.wait(PERIOD):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            samples += 1
            leaves[(frame.f_code.co_filename, frame.f_code.co_name)] += 1
            seen_lines, seen_funcs = set(), set()
            while frame is not None:
                code = frame.f_code
                seen_lines.add((code.co_filename, frame.f_lineno, code.co_name))
                seen_funcs.add((code.co_filename, code.co_name))
                frame = frame.f_back
            lines.update(seen_lines)
            funcs.update(seen_funcs)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    code = 0
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        stop.set()
        sampler.join()
        with open(out_path, "w") as f:
            json.dump({"samples": samples, "wall": time.perf_counter() - t0,
                       "incl": [[list(k), v] for k, v in lines.most_common(4000)],
                       "fincl": [[list(k), v] for k, v in funcs.most_common(1500)],
                       "leaf": [[list(k), v] for k, v in leaves.most_common(600)]}, f)
    return code


if __name__ == "__main__":
    sys.exit(main())
