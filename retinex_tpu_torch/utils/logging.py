"""Training observability: scalars as JSON lines (and TensorBoard events),
loss-curve PNGs and results.csv.

Counterpart of ``retinex_tpu/utils/logging.py``. ``metrics.jsonl`` and
``results.csv`` are always written. TensorBoard events need tensorboardX
and the curve PNGs matplotlib; where either does not import, that output is
left out (the JAX package's ``MetricLogger`` does the same for
tensorboardX).
"""

from __future__ import annotations

import csv
import json
import os
import time


class MetricLogger:
    """Scalar logger: ``<log_dir>/metrics.jsonl``, plus TensorBoard events
    where tensorboardX imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": int(step), "time": time.time()}) + "\n")

    def add_scalars(self, prefix: str, values: dict, step: int):
        for k, v in values.items():
            self.add_scalar(f"{prefix}/{k}", v, step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self):
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


def save_loss_curves(loss_history: dict[str, list[float]], save_dir: str) -> bool:
    """Per-loss and combined loss-curve PNGs under ``<save_dir>/plots``;
    returns False (and writes nothing) where matplotlib does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    plot_dir = os.path.join(save_dir, "plots")
    os.makedirs(plot_dir, exist_ok=True)
    for key, values in loss_history.items():
        if not values:
            continue
        plt.figure(figsize=(10, 6))
        plt.plot(values)
        plt.title(f"{key.capitalize()} Loss Curve")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.grid(True)
        plt.tight_layout()
        plt.savefig(os.path.join(plot_dir, f"{key}_curve.png"))
        plt.close()
    plt.figure(figsize=(12, 8))
    for key, values in loss_history.items():
        if values and key != "total":
            plt.plot(values, label=key.capitalize())
    plt.title("Training Loss Curves")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(os.path.join(plot_dir, "combined_loss_curves.png"))
    plt.close()
    return True


def save_results_to_csv(loss_history: dict[str, list[float]], save_dir: str) -> str:
    """results.csv with one row per epoch."""
    os.makedirs(save_dir, exist_ok=True)
    csv_path = os.path.join(save_dir, "results.csv")
    num_epochs = max((len(v) for v in loss_history.values()), default=0)
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["epoch"] + list(loss_history.keys()))
        writer.writeheader()
        for epoch in range(num_epochs):
            row = {"epoch": epoch}
            for key, values in loss_history.items():
                row[key] = values[epoch] if epoch < len(values) else ""
            writer.writerow(row)
    return csv_path
