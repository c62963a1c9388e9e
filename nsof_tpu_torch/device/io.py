"""Event-stream and simulation-result IO (host-side data layer).

The port's copy of :mod:`nsof_tpu.device.io` (numpy; ``h5py`` is imported
only by the HDF5 functions, which raise ``RuntimeError`` naming it where it
is not installed).

Covers the reference's HDF5 ``/CD/events`` reader (event_mem_sim.py:69-75),
the synthetic-stream HDF5 writer (:358-365), the compressed npz result writer
(:288-303) and the gzipped JSON metadata sidecar (:313-322).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
from pathlib import Path
from typing import Optional

import numpy as np


def load_events_h5(path: str | Path):
    """Load an event stream from HDF5 ``/CD/events`` with x, y, p, t fields.

    Returns (x, y, p, t_us, height, width) with H/W inferred as max+1,
    matching ``load_events`` (event_mem_sim.py:69-75).
    """
    h5py = _h5py(f"reading the event stream {path}")
    with h5py.File(path, "r") as f:
        evs = f["/CD/events"]
        x, y = evs["x"][:], evs["y"][:]
        p, t = evs["p"][:].astype(int), evs["t"][:]
    height, width = int(y.max()) + 1, int(x.max()) + 1
    return x, y, p, t, height, width


def save_events_h5(path: str | Path, x, y, p, t_us) -> None:
    """Write an event stream in the reference's synthetic-HDF5 layout
    (event_mem_sim.py:358-365)."""
    h5py = _h5py(f"writing the event stream {path}")
    with h5py.File(path, "w") as f:
        g = f.create_group("/CD/events")
        g.create_dataset("x", data=np.asarray(x), dtype=np.int16)
        g.create_dataset("y", data=np.asarray(y), dtype=np.int16)
        g.create_dataset("p", data=np.asarray(p), dtype=np.int8)
        g.create_dataset("t", data=np.asarray(t_us), dtype=np.int64)


def events_as_stored(x, y, p, t_us):
    """(x, y, p, t) as :func:`save_events_h5` then :func:`load_events_h5`
    give them back: int16 coordinates, the polarity through int8 to int,
    int64 times.  The CLI's synthetic stream is simulated from these when
    no HDF5 file is written."""
    return (np.asarray(x).astype(np.int16), np.asarray(y).astype(np.int16),
            np.asarray(p).astype(np.int8).astype(int), np.asarray(t_us).astype(np.int64))


def _h5py(what: str):
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(f"{what} needs h5py, which is not installed") from e
    return h5py


def save_sim_npz(path: str | Path, w_final, resistances) -> None:
    """Compressed npz with ``w_final`` + decimated ``resistances`` history
    (event_mem_sim.py:289-303)."""
    np.savez_compressed(
        path,
        w_final=np.asarray(w_final),
        resistances=np.asarray(resistances, dtype=np.float32),
    )


def save_sim_metadata(path: str | Path, cfg, slice_us: int,
                      event_file: Optional[str] = None) -> None:
    """Gzipped JSON metadata enabling exact reproduction
    (event_mem_sim.py:313-322)."""
    meta = dict(
        version=cfg.version,
        slice_us=slice_us,
        fps=1_000_000 / slice_us,
        params=dataclasses.asdict(cfg.params),
        dt=cfg.dt,
        scheme="boxcar" if cfg.version == 1 else "dc_bias_overlay",
        polarity=cfg.polarity if cfg.version == 2 else None,
        theta_events=cfg.theta_events if cfg.version == 1 else None,
        refractory_us=cfg.refractory_us if cfg.version == 2 else None,
        event_file=str(event_file) if event_file else None,
    )
    with gzip.open(path, "wt") as fp:
        json.dump(meta, fp, indent=2)
