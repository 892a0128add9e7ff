"""``device_idle_pct.train``, read in a training cell whose rate is set by
the host's dispatch (``clips_per_s.train_hostbound``)."""

from pathlib import Path

from benchmark import manifest

read = manifest.metric_reader(
    "device_idle_pct.train", Path(__file__).resolve().parents[2])
