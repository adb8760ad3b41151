#!/usr/bin/env python3
"""Hold the port's gate studies to the JAX package's artifacts.

    python3 scripts/compare_gate_rankings.py PORT_DIR [JAX_DIR]
        [--tol 0.005]

``PORT_DIR`` holds ``scripts/run_benchmarks_torch.py --gates``' output
(``<gate>.json`` and ``<gate>_rankings.json``). For each gate it prints a
table of each method's mean NDCG@10 on the port beside the JAX artifact's
(``benchmarks/results/<gate>.json``) mean and SE, with |d| and the gate
pairs' outcomes; then each method whose NDCG@10 on some seed differs from
the artifact's by more than ``--tol``, and, where ``JAX_DIR`` holds the
JAX package's rankings of that seed
(``scripts/record_jax_benchmarks.py --rankings``), the first query whose
top-10 differs, with both lists from the first position that differs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GATES = ("ordering_gate", "attn_gate", "vpt_gate")


def _scale(art: dict) -> float:
    # vpt_ordering_study.py stores NDCG x 100.
    return 100.0 if "topics" in art["config"] else 1.0


def first_difference(port: dict, jax: dict):
    """(qid, position, port ids, JAX ids) of the first query whose
    rankings differ, in the dataset's query order; None if none does."""
    for qid, ids in port.items():
        ref = jax.get(qid)
        if ref != ids:
            pos = next((i for i, (a, b) in enumerate(zip(ids, ref or []))
                        if a != b), min(len(ids), len(ref or [])))
            return qid, pos, ids[pos:], (ref or [])[pos:]
    return None


def compare(gate: str, port_dir: Path, jax_dir: Path | None,
            tol: float) -> None:
    art = json.loads((ROOT / "benchmarks" / "results" / f"{gate}.json")
                     .read_text())
    got = json.loads((port_dir / f"{gate}.json").read_text())
    scale = _scale(art)
    cfg = got["config"]
    print(f"\n=== {gate}: {cfg.get('card', cfg.get('device'))}; "
          f"{cfg['docs']} docs, {cfg['queries']} queries, seeds "
          f"{cfg['seeds']}, R={cfg['R']}, k={cfg['k']} ===")
    print("| method | port mean | JAX mean | JAX SE | abs d |")
    print("| --- | --- | --- | --- | --- |")
    for m, s in sorted(art["stats"].items(), key=lambda kv: -kv[1]["mean"]):
        p = got["stats"].get(m)
        if p is None:
            print(f"| {m} | missing | {s['mean'] / scale:.4f} | "
                  f"{s['se'] / scale:.4f} | |")
            continue
        print(f"| {m} | {p['mean'] / scale:.4f} | {s['mean'] / scale:.4f} "
              f"| {s['se'] / scale:.4f} | "
              f"{abs(p['mean'] - s['mean']) / scale:.4f} |")
    for g in got["gates"]:
        print(f"gate {' > '.join(g['pair'])}: "
              f"{'PASS' if g['ok'] else 'FAIL'}")
    ranks = {}
    for d in (port_dir, jax_dir):
        path = None if d is None else d / f"{gate}_rankings.json"
        ranks[d] = (json.loads(path.read_text())
                    if path is not None and path.exists() else {})
    for m, s in sorted(art["stats"].items()):
        p = got["stats"].get(m)
        if p is None:
            continue
        for seed, a, b in zip(cfg["seeds"], p["per_seed"], s["per_seed"]):
            d = abs(a - b) / scale
            if d <= tol:
                continue
            line = f"{m}, seed {seed}: |d| {d:.4f}"
            name = next((n for n in ranks[port_dir]
                         if n.endswith(f"-s{seed}")), None)
            jax_runs = ranks[jax_dir].get(name, {}).get(m)
            if name is None or jax_runs is None:
                print(line + "; JAX rankings not recorded")
                continue
            diff = first_difference(ranks[port_dir][name][m], jax_runs)
            print(line + ("; rankings equal" if diff is None else
                          f"; first query {diff[0]}, from rank "
                          f"{diff[1] + 1}: port {diff[2]}, JAX {diff[3]}"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port_dir", type=Path)
    ap.add_argument("jax_dir", type=Path, nargs="?")
    ap.add_argument("--tol", type=float, default=0.005)
    args = ap.parse_args()
    for gate in GATES:
        if (args.port_dir / f"{gate}.json").exists():
            compare(gate, args.port_dir, args.jax_dir, args.tol)


if __name__ == "__main__":
    main()
