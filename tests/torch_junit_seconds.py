"""Sum a pytest junit file's test seconds by test module, and compare two.

    python tests/torch_junit_seconds.py run.xml
    python tests/torch_junit_seconds.py before.xml after.xml [--cases 20]

Prints each module's summed seconds (setup, call and teardown, as junit
records them), the sum over the port's `tests/test_torch_*.py` and over
all, and, given two files, the modules side by side and the cases that
moved most. Worker-seconds: with several pytest-xdist workers the sums
exceed the wall time.
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def case_seconds(path) -> dict:
    """{(module, test name): seconds} of a junit file."""
    out = {}
    for tc in ET.parse(path).getroot().iter("testcase"):
        module = tc.get("classname", "").split(".")
        out[(module[1] if len(module) > 1 else module[0], tc.get("name"))] = \
            float(tc.get("time", 0))
    return out


def module_seconds(cases: dict) -> collections.Counter:
    sums = collections.Counter()
    for (module, _), t in cases.items():
        sums[module] += t
    return sums


def port_total(sums) -> float:
    return sum(v for k, v in sums.items() if k.startswith("test_torch_"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--cases", type=int, default=20, help="cases to list that moved most")
    a = ap.parse_args(argv)
    runs = [case_seconds(f) for f in a.files[:2]]
    sums = [module_seconds(c) for c in runs]
    for f, cases, s in zip(a.files, runs, sums):
        n = sum(1 for k in cases if k[0].startswith("test_torch_"))
        print(f"{f}: port {port_total(s):.2f} s ({n} cases), all {sum(s.values()):.2f} s")
    modules = sorted(set().union(*sums), key=lambda m: -max(s.get(m, 0.0) for s in sums))
    for m in modules:
        if m.startswith("test_torch_"):
            print("  " + "  ".join(f"{s.get(m, 0.0):9.2f}" for s in sums) + f"  {m}")
    if len(runs) == 2:
        keys = [k for k in set(runs[0]) | set(runs[1]) if k[0].startswith("test_torch_")]
        keys.sort(key=lambda k: -abs(runs[0].get(k, 0.0) - runs[1].get(k, 0.0)))
        for k in keys[:a.cases]:
            print(f"  {runs[0].get(k, 0.0):9.2f}  {runs[1].get(k, 0.0):9.2f}  {k[0]}::{k[1]}")


if __name__ == "__main__":
    main()
