"""Rational-Bloom-filter FPR experiments.

The port's copy of ``new_bloom_filter_repo_tpu.experiments`` (host
only): empirical vs theoretical false-positive-rate comparison of
standard (integer-k) and rational (fractional-k) filters, sweeps over k
and m/n, and matplotlib artifacts (matplotlib is imported only when a
plot is drawn).

    python -m new_bloom_filter_repo_tpu_torch.experiments --output-dir plots/
"""

from __future__ import annotations

import argparse
import math
import random
import string
import sys
from typing import Dict, List

from new_bloom_filter_repo_tpu_torch.models.bloom import (
    RationalBloomFilter,
    StandardBloomFilter,
)


def generate_random_strings(n: int, length: int = 10,
                            rng: random.Random = None) -> List[str]:
    rng = rng or random
    return ["".join(rng.choices(string.ascii_lowercase, k=length))
            for _ in range(n)]


def measure_false_positive_rate(bloom_filter, true_elements, test_elements):
    """Fraction of non-members reported present
    (reference: rational_bloom_filter.py:222-247)."""
    fp = sum(1 for e in test_elements
             if e not in true_elements and bloom_filter.contains(e))
    total = sum(1 for e in test_elements if e not in true_elements)
    return fp / total if total else 0.0


def theoretical_fpr(m: int, n: int, k: float) -> float:
    """(1 - e^{-kn/m})^k — the classic approximation."""
    return (1 - math.exp(-k * n / m)) ** k


def theoretical_fpr_rational(m: int, n: int, k_star: float) -> float:
    """Exact rational formula: the fractional lane applies with
    probability frac(k*) (reference: rational_bloom_filter.py:359-363)."""
    kf = math.floor(k_star)
    frac = k_star - kf
    fill = 1 - math.exp(-k_star * n / m)
    return (fill ** kf) * (frac * fill + (1 - frac))


def compare_filters(n: int = 1000, m: int = 8192, probes: int = 20000,
                    seed: int = 42) -> Dict:
    """Standard floor(k*)/ceil(k*) vs rational k* on the same data
    (reference: rational_bloom_filter.py:250-320)."""
    rng = random.Random(seed)
    items = generate_random_strings(n, rng=rng)
    tests = generate_random_strings(probes, rng=rng)
    true_set = set(items)

    k_star = RationalBloomFilter.get_optimal_hash_count(m, n)
    results = {"m": m, "n": n, "k_star": k_star}
    for name, flt in (
        ("standard_floor", StandardBloomFilter(m, math.floor(k_star) or 1)),
        ("standard_ceil", StandardBloomFilter(m, math.ceil(k_star))),
        ("rational", RationalBloomFilter(m, k_star)),
    ):
        for it in items:
            flt.add(it)
        fpr = measure_false_positive_rate(flt, true_set, tests)
        k = getattr(flt, "hash_count", getattr(flt, "k_star", None))
        results[name] = {
            "k": k,
            "empirical_fpr": fpr,
            "theoretical_fpr": (theoretical_fpr_rational(m, n, k)
                                if name == "rational"
                                else theoretical_fpr(m, n, k)),
        }
    return results


def run_experiment_varying_k(n: int = 500, m: int = 4096,
                             probes: int = 10000, steps: int = 13,
                             seed: int = 7) -> Dict:
    """Sweep k* across a range around optimum; empirical vs theoretical
    (reference: rational_bloom_filter.py:323-407)."""
    rng = random.Random(seed)
    items = generate_random_strings(n, rng=rng)
    tests = generate_random_strings(probes, rng=rng)
    true_set = set(items)
    k_opt = RationalBloomFilter.get_optimal_hash_count(m, n)
    ks = [max(0.25, k_opt * (0.25 + 1.5 * i / (steps - 1)))
          for i in range(steps)]
    emp, theo = [], []
    for k in ks:
        flt = RationalBloomFilter(m, k)
        for it in items:
            flt.add(it)
        emp.append(measure_false_positive_rate(flt, true_set, tests))
        theo.append(theoretical_fpr_rational(m, n, k))
    return {"k_values": ks, "empirical": emp, "theoretical": theo,
            "k_optimal": k_opt, "m": m, "n": n}


def run_theoretical_comparison(mn_ratios=None, seed: int = 3,
                               n: int = 400, probes: int = 8000) -> Dict:
    """FPR improvement of rational over best-integer k across m/n
    (reference: rational_bloom_filter.py:410-494 and
    test_bloom_filters.py:69-137)."""
    mn_ratios = mn_ratios or [2, 4, 6, 8, 10, 12, 14, 16, 18, 20]
    rng = random.Random(seed)
    items = generate_random_strings(n, rng=rng)
    tests = generate_random_strings(probes, rng=rng)
    true_set = set(items)
    rows = []
    for ratio in mn_ratios:
        m = int(ratio * n)
        k_star = RationalBloomFilter.get_optimal_hash_count(m, n)
        rational = RationalBloomFilter(m, k_star)
        floor_f = StandardBloomFilter(m, max(1, math.floor(k_star)))
        ceil_f = StandardBloomFilter(m, math.ceil(k_star))
        for it in items:
            rational.add(it)
            floor_f.add(it)
            ceil_f.add(it)
        r = measure_false_positive_rate(rational, true_set, tests)
        fl = measure_false_positive_rate(floor_f, true_set, tests)
        ce = measure_false_positive_rate(ceil_f, true_set, tests)
        best_std = min(fl, ce)
        rows.append({"m_over_n": ratio, "k_star": k_star,
                     "rational_fpr": r, "floor_fpr": fl, "ceil_fpr": ce,
                     "improvement_pct": (100 * (best_std - r) / best_std
                                         if best_std > 0 else 0.0)})
    return {"rows": rows, "n": n}


def _plot(results_k, results_mn, output_dir: str):
    import os
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(output_dir, exist_ok=True)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(results_k["k_values"], results_k["empirical"], "o-",
            label="empirical")
    ax.plot(results_k["k_values"], results_k["theoretical"], "s--",
            label="theoretical")
    ax.axvline(results_k["k_optimal"], color="gray", ls=":",
               label=f"k* = {results_k['k_optimal']:.2f}")
    ax.set_xlabel("k (rational)")
    ax.set_ylabel("false positive rate")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    p1 = f"{output_dir}/fpr_vs_k.png"
    fig.savefig(p1, dpi=110)
    plt.close(fig)

    rows = results_mn["rows"]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.bar([r["m_over_n"] for r in rows],
           [r["improvement_pct"] for r in rows], width=1.2)
    ax.set_xlabel("m / n")
    ax.set_ylabel("FPR improvement over best integer k (%)")
    ax.grid(True, alpha=0.3, axis="y")
    p2 = f"{output_dir}/rational_improvement.png"
    fig.savefig(p2, dpi=110)
    plt.close(fig)
    return [p1, p2]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Rational Bloom FPR experiments")
    ap.add_argument("--output-dir", default="plots")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    scale = 4 if args.quick else 1

    cmp_res = compare_filters(n=1000 // scale, probes=20000 // scale)
    print("filter comparison (m=8192, n=1000):")
    for name in ("standard_floor", "standard_ceil", "rational"):
        r = cmp_res[name]
        print(f"  {name:15s} k={r['k']:<6.3f} empirical={r['empirical_fpr']:.5f}"
              f" theoretical={r['theoretical_fpr']:.5f}")

    rk = run_experiment_varying_k(probes=10000 // scale)
    rmn = run_theoretical_comparison(probes=8000 // scale)
    print("\nm/n sweep (rational vs best integer k):")
    for row in rmn["rows"]:
        print(f"  m/n={row['m_over_n']:>3} k*={row['k_star']:.2f} "
              f"improvement={row['improvement_pct']:+.1f}%")
    try:
        paths = _plot(rk, rmn, args.output_dir)
        print(f"\nplots: {paths}")
    except ImportError:
        print("matplotlib unavailable; skipped plots")
    return 0


if __name__ == "__main__":
    sys.exit(main())
