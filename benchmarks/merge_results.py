#!/usr/bin/env python
"""Merge per-pass results JSONs into one canonical round file.

Later passes override earlier rows with the same (name, shape) key —
re-running a single bench (e.g. after an oracle fix) replaces just its
rows.  When a bench group was fully re-run its old rows may carry stale
shape strings (fill/levels change with the packer), so ``--fresh
group1,group2`` evicts every earlier row of those groups before merging
the later files.  Usage:

    python benchmarks/merge_results.py [--fresh g1,g2] out.json in1.json ...
"""
import json
import sys


def main():
    args = sys.argv[1:]
    fresh: set[str] = set()
    if args and args[0] == "--fresh":
        fresh = set(args[1].split(","))
        args = args[2:]
    out_path, *ins = args
    rows: dict[tuple, dict] = {}
    order: list[tuple] = []
    # for each --fresh group, find the LAST input file containing it; all
    # of that group's rows in EARLIER files are evicted wholesale (stale
    # shape strings from any prior session, not just the base file)
    last_file_of_group: dict[str, int] = {}
    for i, path in enumerate(ins):
        for r in json.load(open(path)):
            last_file_of_group[r["name"].split("/")[0]] = i
    evict = {g for g in fresh
             if g in last_file_of_group and last_file_of_group[g] > 0}
    if fresh - set(last_file_of_group):
        print(f"warning: --fresh groups never measured at all: "
              f"{sorted(fresh - set(last_file_of_group))}", file=sys.stderr)

    for i, path in enumerate(ins):
        for r in json.load(open(path)):
            group = r["name"].split("/")[0]
            if group in evict and i < last_file_of_group[group]:
                continue
            key = (r["name"], r["shape"])
            if key not in rows:
                order.append(key)
                rows[key] = r
                continue
            prev = rows[key]
            # identical config measured in multiple sessions: keep the
            # faster one IF both passed their checks (timings can vary
            # ~2x between runs); otherwise the later row wins
            # (oracle/check fixes change `checked`).  Dense-race rows
            # carry no check but must ALSO keep their fastest session —
            # replacing a fast race with a slow-session one would
            # overstate the sparse win against it.
            both_ok = prev.get("checked") is True and r.get("checked") is True
            race = "dense-race" in r["name"]
            if (both_ok or race) and prev["min_ms"] < r["min_ms"]:
                continue
            rows[key] = r
    merged = [rows[k] for k in order]
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"{out_path}: {len(merged)} rows from {len(ins)} files"
          + (f" (evicted stale groups: {sorted(evict)})" if evict else ""))


if __name__ == "__main__":
    main()
