"""Minimal Tkinter front-end for the fall-detection pipeline.

    python -m shift_gcn_torch.inference.gui [--device cpu]

The reference package's ``inference/gui.py`` over this package's
pipeline (the reference's GUI, inference_pipeline.py:677-823): pick a
video, pick a checkpoint (a ``.pt`` / ``.pkl`` / ``.pth`` file, a run's
save dir or a save-models root, ``resolve_checkpoints``), run the
ensemble through ``run_pipeline`` on the card in a worker thread,
optionally write the annotated video, and show the report's summary.
tkinter is imported by ``launch`` alone: the module imports without it.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from typing import Dict, Optional, Tuple

from shift_gcn_torch.inference.pipeline import auto_detect_checkpoints
from shift_gcn_torch.utils.checkpoint import latest_checkpoint
from shift_gcn_torch.utils.device import resolve_device


def resolve_checkpoints(path: str
                        ) -> Tuple[Optional[Dict[str, str]], Optional[str]]:
    """A user-picked path -> ``run_pipeline``'s (checkpoints,
    fourstream_checkpoint), (None, None) when nothing is found.

    A ``.pt`` / ``.pkl`` / ``.pth`` file is the joint stream's; a
    save-models root goes through ``auto_detect_checkpoints``; a run's
    save dir gives its newest checkpoint, a four-stream one when the
    dir's name says ``fourstream`` (the Trainer's four-stream
    experiments do).  The reference package's Orbax step dirs
    (digit-named) are refused: export one to ``.pt`` first
    (``utils/checkpoint.py``)."""
    def is_fourstream(p: str) -> bool:
        return "fourstream" in os.path.basename(os.path.normpath(p)).lower()

    if os.path.isfile(path) and path.endswith((".pt", ".pkl", ".pth")):
        return {"joint": path}, None
    if os.path.isdir(path) and os.path.basename(
            os.path.normpath(path)).isdigit():
        raise ValueError(
            f"{path} looks like an Orbax step directory of the reference "
            "package, which this package does not read: export it to a "
            ".pt file with the reference package's checkpoint CLI first")
    found = auto_detect_checkpoints(path)
    if found:
        return found, None
    latest = latest_checkpoint(path)
    if latest:
        if is_fourstream(path):
            return None, latest
        return {"joint": latest}, None
    return None, None


def launch(default_checkpoints: Optional[Dict[str, str]] = None,
           device="cuda") -> None:
    """Open the window; ``run_pipeline`` runs on ``device``, the card
    unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    import tkinter as tk
    from tkinter import filedialog, messagebox, scrolledtext

    from shift_gcn_torch.inference.pipeline import run_pipeline

    root = tk.Tk()
    root.title("shift_gcn_torch fall detection")
    root.geometry("640x480")

    video_var = tk.StringVar()
    ckpt_var = tk.StringVar(
        value=(default_checkpoints or {}).get("joint", ""))
    threshold_var = tk.DoubleVar(value=0.5)
    annotate_var = tk.BooleanVar(value=False)

    def pick_video():
        path = filedialog.askopenfilename(
            filetypes=[("videos", "*.mp4 *.avi *.mkv"), ("all", "*")])
        if path:
            video_var.set(path)

    def pick_ckpt():
        path = filedialog.askdirectory()
        if path:
            ckpt_var.set(path)

    output = None  # assigned below

    def show(text: str) -> None:
        output.delete("1.0", tk.END)
        output.insert(tk.END, text)

    def run():
        video = video_var.get()
        ckpt = ckpt_var.get()
        if not video or not ckpt:
            messagebox.showerror("error", "select a video and a checkpoint")
            return
        threshold = float(threshold_var.get())
        annotate = annotate_var.get()

        def work():
            try:
                ckpts, fourstream = resolve_checkpoints(ckpt)
                if ckpts is None and fourstream is None:
                    raise FileNotFoundError(
                        f"no checkpoints found under {ckpt}")
                out_video = (os.path.splitext(video)[0] + "_annotated.mp4"
                             if annotate else None)
                report = run_pipeline(
                    video, ckpts, fourstream_checkpoint=fourstream,
                    threshold=threshold,
                    output_json=os.path.splitext(video)[0] + "_report.json",
                    output_video=out_video, device=device)
                summary = {k: v for k, v in report.items()
                           if k != "frame_probabilities"}
                summary["streams"] = sorted(ckpts) if ckpts else [
                    "fourstream"]
                text = json.dumps(summary, indent=2)
            except Exception as e:  # surface errors in the UI
                text = f"ERROR: {e}"
            root.after(0, show, text)  # widgets belong to Tk's thread

        threading.Thread(target=work, daemon=True).start()
        show("running...")

    row = tk.Frame(root)
    row.pack(fill="x", padx=8, pady=4)
    tk.Entry(row, textvariable=video_var).pack(
        side="left", expand=True, fill="x")
    tk.Button(row, text="video...", command=pick_video).pack(side="right")

    row2 = tk.Frame(root)
    row2.pack(fill="x", padx=8, pady=4)
    tk.Entry(row2, textvariable=ckpt_var).pack(
        side="left", expand=True, fill="x")
    tk.Button(row2, text="checkpoint...", command=pick_ckpt).pack(
        side="right")

    row3 = tk.Frame(root)
    row3.pack(fill="x", padx=8, pady=4)
    tk.Label(row3, text="threshold").pack(side="left")
    tk.Scale(row3, variable=threshold_var, from_=0.1, to=0.9,
             resolution=0.05, orient="horizontal").pack(
        side="left", expand=True, fill="x")
    tk.Checkbutton(row3, text="annotated video",
                   variable=annotate_var).pack(side="right")
    tk.Button(row3, text="run", command=run).pack(side="right")

    output = scrolledtext.ScrolledText(root)
    output.pack(expand=True, fill="both", padx=8, pady=8)

    root.mainloop()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs (cpu: the plain path)")
    launch(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
