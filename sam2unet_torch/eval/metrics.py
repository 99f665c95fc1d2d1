"""The evaluation report, the port's copy of the part of
sam2unet_tpu/eval/metrics.py the train CLI's device evaluation uses: the
metric names and `print_eval_report` (reference eval.py:23-52)."""

from __future__ import annotations

MIOU = "mIoU"
MDICE = "mDice"


def print_eval_report(results: dict, title: str = "Evaluation Results",
                      log_path: str | None = None) -> str:
    """Formatted report block, byte-compatible with the reference's; appended
    to `log_path` when given."""
    width = max(len(title) + 2, 25)
    report = [f"\n{'=' * width}", f"{title:^{width}}", f"{'-' * width}"]
    for metric, value in results.items():
        display = metric.replace("_", " ")
        if isinstance(value, float):
            report.append(f"{display:<{width - 8}}: {value:>6.4f}")
        else:
            report.append(f"{display:<{width - 8}}: {value:>6}")
    report.append(f"{'=' * width}\n")
    full = "\n".join(report)
    print(full)
    if log_path:
        with open(log_path, "a") as f:
            f.write(full)
    return full
