#!/usr/bin/env python
"""Plots for the benchmark harness CSVs.

Port of the reference plotting script (reference:
scripts/plot_runtime_memory.py): runtime and peak-RSS vs DB size from
runtime_memory.py output, speedup/efficiency vs devices from speedup.py
output. Produces PNGs next to the input CSVs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import pandas as pd


def plot_runtime_memory(csv_path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    df = pd.read_csv(csv_path)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    sns.lineplot(
        df, x="size", y="runtime_s", hue="tool", marker="o", ax=axes[0]
    )
    axes[0].set(xlabel="database size (records)", ylabel="runtime [s]")
    sns.lineplot(
        df, x="size", y="peak_rss_mb", hue="tool", marker="o", ax=axes[1]
    )
    axes[1].set(xlabel="database size (records)", ylabel="peak RSS [MB]")
    fig.tight_layout()
    out = csv_path.with_suffix(".png")
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_speedup(csv_path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    df = pd.read_csv(csv_path)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    sns.lineplot(df, x="devices", y="speedup", marker="o", ax=axes[0])
    axes[0].plot(
        df["devices"], df["devices"], linestyle="--", color="gray",
        label="ideal",
    )
    axes[0].set(xlabel="devices", ylabel="speedup")
    axes[0].legend()
    sns.lineplot(df, x="devices", y="efficiency", marker="o", ax=axes[1])
    axes[1].axhline(1.0, linestyle="--", color="gray")
    axes[1].set(xlabel="devices", ylabel="parallel efficiency", ylim=(0, 1.1))
    fig.tight_layout()
    out = csv_path.with_suffix(".png")
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("csv", type=Path)
    ap.add_argument(
        "--kind", choices=["runtime_memory", "speedup"],
        default="runtime_memory",
    )
    args = ap.parse_args()
    if args.kind == "speedup":
        plot_speedup(args.csv)
    else:
        plot_runtime_memory(args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
