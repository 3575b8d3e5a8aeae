"""Metrics writer (port of nerfpp_tpu/utils/metrics.py): scalars appended
to ``metrics.csv`` every IPrint steps, a rendered validation view written
to ``images/`` every IImg steps (as PNG, through utils/png.py)."""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict

import numpy as np

from nerfpp_tpu_torch.utils.png import write_png


class MetricsWriter:
    def __init__(self, base_dir):
        self.base_dir = Path(base_dir)
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.base_dir / "metrics.csv"
        # resume-aware: adopt the existing file's header so appended rows
        # stay aligned with it
        self._fieldnames = None
        if self.csv_path.exists():
            with open(self.csv_path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fieldnames = list(header)

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        # keys that appear later widen the header: rewrite the file once
        # with blank back-fill
        new_keys = [k for k in row if k not in self._fieldnames]
        if new_keys:
            old_rows = []
            if self.csv_path.exists():
                with open(self.csv_path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
            self._fieldnames = self._fieldnames + new_keys
            with open(self.csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames,
                                   restval="")
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        new_file = not self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, restval="")
            if new_file:
                w.writeheader()
            w.writerow(row)

    def write_image(self, step: int, name: str, image) -> None:
        """image: [h, w, 3] float in [0, 1] (RGB, a tensor or an array),
        written as images/<name>_<step:08d>.png (truncated to 8 bits, as
        the JAX package writes it)."""
        if hasattr(image, "detach"):
            image = image.detach().float().cpu().numpy()
        img_dir = self.base_dir / "images"
        img_dir.mkdir(exist_ok=True)
        arr = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
        write_png(img_dir / f"{name}_{step:08d}.png", arr)
