"""Training visualisation for RefineNet (counterpart of
mofanerf_tpu/utils/visualizer.py): the console and `loss_log.txt` lines, PNGs
of the visuals through the port's PNG writer, and an HTML index of them
grouped by epoch, newest first, byte-equal to the JAX package's."""
from __future__ import annotations

import os
import re
import time
from typing import Dict

import numpy as np

from mofanerf_tpu_torch.utils.image_io import write_png


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img * 255, 0, 255).astype(np.uint8)


class Visualizer:
    def __init__(self, out_dir: str, name: str = "experiment"):
        self.out_dir = out_dir
        self.name = name
        self.img_dir = os.path.join(out_dir, "web", "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.log_path = os.path.join(out_dir, "loss_log.txt")
        with open(self.log_path, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    def print_errors(self, epoch: int, i: int, errors: Dict[str, float], t: float) -> None:
        msg = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) " + " ".join(
            f"{k}: {float(v):.3f}" for k, v in errors.items())
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def save_images(self, epoch: int, visuals: Dict[str, np.ndarray]) -> None:
        for label, img in visuals.items():
            write_png(os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.png"), _to_u8(img))
        self._write_index()

    def save_result_image(self, out_dir: str, name: str, img: np.ndarray) -> str:
        """One inference output as `<out_dir>/<name>.png`."""
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{name}.png")
        write_png(path, _to_u8(img))
        return path

    def _write_index(self, refresh: int = 30, width: int = 256) -> None:
        """A gallery of the saved visuals grouped by epoch, newest first,
        refreshing itself."""
        by_epoch: dict = {}
        for f in sorted(os.listdir(self.img_dir)):
            m = re.match(r"epoch(\d+)_(.+)\.(png|jpg)$", f)
            if m:
                by_epoch.setdefault(int(m.group(1)), []).append((f, m.group(2)))

        sections = []
        for epoch in sorted(by_epoch, reverse=True):
            cells = "".join(
                f'<td style="word-wrap:break-word;text-align:center;'
                f'vertical-align:top"><p><a href="images/{f}">'
                f'<img style="width:{width}px" src="images/{f}"/></a><br/>'
                f"<p>{label}</p></p></td>"
                for f, label in by_epoch[epoch])
            sections.append(
                f"<h3>epoch [{epoch}]</h3>"
                f'<table border="1" style="table-layout:fixed"><tr>{cells}</tr></table>')
        html = (
            f'<html><head><title>{self.name}</title>'
            f'<meta http-equiv="refresh" content="{refresh}"/></head>'
            f"<body><h1>Experiment name = {self.name}</h1>"
            f"{''.join(sections)}</body></html>")
        with open(os.path.join(self.out_dir, "web", "index.html"), "w") as f:
            f.write(html)
