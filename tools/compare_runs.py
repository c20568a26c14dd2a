#!/usr/bin/env python3
"""Compare the deterministic fields of two runs.

    python3 tools/compare_runs.py smoke PARENT.log CHANGE.log
    python3 tools/compare_runs.py bench BENCH_ingest.json FRESH.json

``smoke``: two outputs of ``python3 chip_smoke.py`` (JSON lines).  The
lines of the phases both runs have are compared in order with their
timing fields dropped (seconds, milliseconds, rates and ratios of times,
peaks, build logs and the profiler's kernel list), aligned as a diff
aligns them: a line only the change has (a case or cell it adds) is
listed as added, and every other difference counts.  Each main path the
parent names in the ``launches`` line must have the same launch counts in
the change.  ``bench``: a
checked-in ``BENCH_ingest.json`` and a fresh ``benchmarks/bench_ingest.py``
output; every field of every arm except ``events_per_sec``, and every
cost ratio, must be equal.  Prints each difference and exits 1 if any.
"""
import difflib
import json
import re
import sys

TIMING = re.compile(r"(seconds|_ms$|^ms$|^ms_|_ms_|per_second|per_sec$|wall"
                    r"|^s_per_"
                    r"|peak|build|ptxas|zorder_sass|elapsed|time|^card$"
                    r"|rate|tokens_per|idle|share|busy|^over_|^cuda$"
                    r"|^torch$)")


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if not TIMING.search(k)}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def smoke(parent_path: str, change_path: str) -> int:
    def lines(path):
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.startswith('{"phase"')]
    parent, change = lines(parent_path), lines(change_path)
    phases = {d["phase"] for d in parent} - {"env", "launches"}

    def key(d):
        # the profiler window's kernel list: names and times vary
        return json.dumps(strip(dict(d, top_kernels=None)), sort_keys=True)
    a = [d for d in parent if d["phase"] in phases]
    b = [d for d in change if d["phase"] in phases]
    bad = added = 0
    ops = difflib.SequenceMatcher(None, [key(d) for d in a],
                                  [key(d) for d in b],
                                  autojunk=False).get_opcodes()
    for op, i1, i2, j1, j2 in ops:
        if op == "insert":
            added += j2 - j1
            for y in b[j1:j2]:
                print("added:", key(y)[:300])
        elif op != "equal":
            bad += max(i2 - i1, j2 - j1)
            for x, y in zip(a[i1:i2] + [{}] * (j2 - j1 - i2 + i1),
                            b[j1:j2] + [{}] * (i2 - i1 - j2 + j1)):
                sx, sy = strip(x), strip(y)
                diff = {k: (sx.get(k), sy.get(k))
                        for k in sorted(set(sx) | set(sy))
                        if sx.get(k) != sy.get(k)}
                print("differs:", x.get("phase", y.get("phase")),
                      json.dumps(diff)[:600])
    runs = [[d for d in r if d["phase"] == "launches"][0]["per_main_path"]
            for r in (parent, change)]
    for path, counts in runs[0].items():
        if runs[1].get(path) != counts:
            bad += 1
            print("launches differ:", path, counts, runs[1].get(path))
    print(f"{len(a)} lines and {len(runs[0])} main paths compared; "
          f"{bad} differ, {added} added")
    return 1 if bad else 0


def bench(checked_in: str, fresh: str) -> int:
    with open(checked_in) as f:
        want = json.load(f)
    with open(fresh) as f:
        got = json.load(f)
    bad = n = 0
    for w, g in zip(want["results"], got["results"]):
        for arm, fields in w["arms"].items():
            for k, v in fields.items():
                if k == "events_per_sec":
                    continue
                n += 1
                if g["arms"][arm][k] != v:
                    bad += 1
                    print("differs:", w["scenario"], arm, k, v,
                          g["arms"][arm][k])
        n += len(w["cost_ratio_vs_debt_aware"])
        if g["cost_ratio_vs_debt_aware"] != w["cost_ratio_vs_debt_aware"]:
            bad += 1
            print("ratios differ:", w["scenario"])
    print(f"{n} fields compared; {bad} differ")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] not in ("smoke", "bench"):
        sys.exit(__doc__)
    sys.exit({"smoke": smoke, "bench": bench}[sys.argv[1]](*sys.argv[2:]))
