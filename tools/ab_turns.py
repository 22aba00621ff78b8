"""Two checkouts of the repository in turns on one card: what
tools/run_pnp_phase.py and tools/run_hamming_phase.py share for their
``--ab``.

``run`` starts, per turn (other, this, this, other with four turns; other,
this with two), a process ``python3 SCRIPT --turn ROOT`` from that
checkout's root, so that it imports only its own package; keeps each
turn's log under ``out``; reads each turn's numbers from its lines with
``patterns`` ((key, regular expression, conversion): the first line that
matches gives the key its value); and prints them per turn and as medians
per checkout (a string key: its distinct values), writing all of it to
``out/ab.json``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(lines, patterns) -> dict:
    out = {}
    for key, pat, conv in patterns:
        for line in lines:
            m = re.search(pat, line)
            if m:
                out[key] = conv(m.group(1))
                break
    return out


def run(script: str, other: str, turns: int, out: str, patterns,
        echo=("[turn]", "[time]", "NVIDIA")) -> int:
    """The turns of ``script`` on ``other`` and this checkout; lines that
    start with one of ``echo`` are printed as they come.  Returns 1 when a
    turn failed."""
    os.makedirs(out, exist_ok=True)
    order = [("other", other), ("this", ROOT)] * (turns // 2)
    if turns == 4:
        order = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    results, rc = [], 0
    for tag, root in order:
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(script), "--turn", root],
                              capture_output=True, text=True, cwd=root)
        lines = proc.stdout.splitlines()
        with open(os.path.join(out, f"turn{len(results)}_{tag}.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        got = parse(lines, patterns)
        got.update(turn=tag, rc=proc.returncode, seconds=round(time.time() - t0, 1))
        results.append(got)
        rc |= proc.returncode != 0
        for line in lines:
            if line.startswith(echo) or "Traceback" in line:
                print(f"[ab {tag}] {line}")
        if proc.returncode != 0:
            print(f"[ab {tag}] stderr tail:\n" + "\n".join(proc.stderr.splitlines()[-15:]))
        print(f"[ab] turn {len(results)} ({tag}, rc {proc.returncode}, {got['seconds']} s): "
              + json.dumps({k: v for k, v in got.items() if k not in ("turn", "rc", "seconds")}),
              flush=True)
    summary = {}
    for tag in ("other", "this"):
        mine = [r for r in results if r["turn"] == tag]
        summary[tag] = {}
        for key, _, conv in patterns:
            vals = [r[key] for r in mine if key in r]
            if vals:
                summary[tag][key] = (statistics.median(vals) if conv is not str
                                     else sorted(set(vals)))
    for key, _, conv in patterns:
        a, b = summary["other"].get(key), summary["this"].get(key)
        ratio = (f", other / this {a / b:.3f}" if conv is not str and a is not None and b
                 else "")
        print(f"[ab] {key}: other {a}, this {b}{ratio}")
    with open(os.path.join(out, "ab.json"), "w") as f:
        json.dump({"turns": results, "summary": summary}, f, indent=1)
    return int(rc)
