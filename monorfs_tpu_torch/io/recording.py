"""Recording zip reader/writer, byte-compatible with the reference format:
the port's own copy of monorfs_tpu.io.recording.

Reference: Simulation.SaveToFile (Simulation.cs:391-488) writes a zip with
  scene.world, trajectory.out, odometry.out, estimate.out, maps.out,
  vismaps.out, measurements.out, tags.out, config.cfg [, sidebar.avi]
and RecordVehicle.FromFile (RecordVehicle.cs:244-347) + FileParser
(FileParser.cs:51-341) read it back.
"""

import dataclasses
import zipfile
from typing import List, Tuple

import numpy as np

from .world import World, _g6


def _fmt_vec(time, vec):
    return _g6(time) + " " + " ".join(_g6(v) for v in vec)


def serialize_timed_array(entries):
    """[(time, vector)] -> line-per-entry text (Simulation.cs:225-231)."""
    return "\n".join(_fmt_vec(t, v) for t, v in entries)


def parse_timed_array(text, dim=None):
    out = []
    for line in text.splitlines():
        if not line.strip():
            continue
        vals = [float(v) for v in line.split()]
        if dim is not None and len(vals) != dim + 1:
            raise ValueError("wrong state dimension")
        out.append((vals[0], np.array(vals[1:])))
    return out


def serialize_history(frames, inner):
    """[(time, payload)] framed with '\\n|\\n' separators
    (FileParser.cs:65-95)."""
    return "\n|\n".join(_g6(t) + "\n" + inner(p) for t, p in frames)


def parse_history(text, inner):
    frames = []
    for frame in text.split("\n|\n"):
        lines = [ln for ln in frame.split("\n") if ln.strip()]
        if not lines:
            continue
        frames.append((float(lines[0]), inner(lines[1:])))
    return frames


def serialize_gaussian(weight, mean, cov):
    """w;mean;row-major covariance (Gaussian.cs:391-...; parsed at
    FileParser.cs:302-339)."""
    return (
        _g6(weight)
        + ";"
        + " ".join(_g6(v) for v in mean)
        + ";"
        + " ".join(_g6(v) for v in np.asarray(cov).reshape(-1))
    )


def parse_gaussian(line):
    parts = line.split(";")
    weight = float(parts[0])
    mean = np.array([float(v) for v in parts[1].split()])
    cov = np.array([float(v) for v in parts[2].split()]).reshape(
        len(mean), len(mean)
    )
    return weight, mean, cov


def serialize_map(components):
    """components: list of (w, mean, cov)."""
    return "\n".join(serialize_gaussian(*c) for c in components)


def serialize_measurements(frames):
    """[(time, [vec, ...])] -> 'time:z1;z2;...' lines
    (FileParser.cs:179-230)."""
    return "\n".join(
        _g6(t) + ":" + ";".join(" ".join(_g6(v) for v in z) for z in zs)
        for t, zs in frames
    )


def parse_measurements(text):
    frames = []
    for line in text.splitlines():
        if not line.strip():
            continue
        tpart, zpart = line.split(":", 1)
        zs = [
            np.array([float(v) for v in p.split()])
            for p in zpart.split(";")
            if p.strip()
        ]
        frames.append((float(tpart), zs))
    return frames


def serialize_sightings(frames):
    """[(time, [label, ...])] -> 'time:l1 l2 ...' lines. Extension member
    (sightings.out): true landmark association labels per measurement slot
    (clutter = -2), aligned with measurements.out. The reference keeps
    these only in memory (SimulatedVehicle labels the detections it
    samples) so known-DA runs can't replay from its recordings; persisting
    them makes `-i record` + DAAlgorithm Perfect work (chap4 S6/S8)."""
    return "\n".join(
        _g6(t) + ":" + " ".join(str(int(l)) for l in ls)
        for t, ls in frames
    )


def parse_sightings(text):
    frames = []
    for line in text.splitlines():
        if not line.strip():
            continue
        tpart, lpart = line.split(":", 1)
        frames.append(
            (float(tpart), [int(v) for v in lpart.split()])
        )
    return frames


def serialize_tags(tags):
    return "\n".join(_g6(t) + " " + msg for t, msg in tags)


def parse_tags(text):
    out = []
    for line in text.splitlines():
        if not line.strip():
            continue
        parts = line.split(" ", 1)
        out.append((float(parts[0]), parts[1] if len(parts) > 1 else ""))
    return out


@dataclasses.dataclass
class Recording:
    """In-memory recording contents."""

    world: World
    trajectory: List[Tuple[float, np.ndarray]]  # groundtruth states
    odometry: List[Tuple[float, np.ndarray]]  # noisy readings
    estimate: List[Tuple[float, List[Tuple[float, np.ndarray]]]]  # history
    maps: List[Tuple[float, List]]  # [(time, [(w, mean, cov)])]
    vismaps: List[Tuple[float, List]]
    measurements: List[Tuple[float, List[np.ndarray]]]
    tags: List[Tuple[float, str]]
    config_text: str
    # true association labels per measurement (extension; [] when absent)
    sightings: List[Tuple[float, List[int]]] = dataclasses.field(
        default_factory=list
    )
    # sensor-view video (MJPEG AVI bytes, io/avi.py; the reference embeds
    # sidebar.avi, Simulation.cs:391-488); empty when the run has none
    sidebar: bytes = b""

    def save(self, filename):
        with zipfile.ZipFile(filename, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("scene.world", self.world.serialize())
            zf.writestr("trajectory.out", serialize_timed_array(self.trajectory))
            zf.writestr("odometry.out", serialize_timed_array(self.odometry))
            zf.writestr(
                "estimate.out",
                serialize_history(self.estimate, serialize_timed_array),
            )
            zf.writestr("maps.out", serialize_history(self.maps, serialize_map))
            zf.writestr(
                "vismaps.out", serialize_history(self.vismaps, serialize_map)
            )
            zf.writestr(
                "measurements.out", serialize_measurements(self.measurements)
            )
            zf.writestr("tags.out", serialize_tags(self.tags))
            zf.writestr("config.cfg", self.config_text)
            if self.sightings:
                zf.writestr(
                    "sightings.out", serialize_sightings(self.sightings)
                )
            if self.sidebar:
                zf.writestr("sidebar.avi", self.sidebar)

    @classmethod
    def load(cls, filename) -> "Recording":
        with zipfile.ZipFile(filename) as zf:
            def read_bytes(name):
                try:
                    return zf.read(name)
                except KeyError:
                    return b""

            def read(name):
                return read_bytes(name).decode("utf-8")

            world = World.parse(read("scene.world"))
            dim = len(world.pose)
            return cls(
                world=world,
                trajectory=parse_timed_array(read("trajectory.out")),
                odometry=parse_timed_array(read("odometry.out")),
                estimate=parse_history(
                    read("estimate.out"),
                    lambda lines: parse_timed_array("\n".join(lines)),
                ),
                maps=parse_history(
                    read("maps.out"),
                    lambda lines: [parse_gaussian(ln) for ln in lines],
                ),
                vismaps=parse_history(
                    read("vismaps.out"),
                    lambda lines: [parse_gaussian(ln) for ln in lines],
                ),
                measurements=parse_measurements(read("measurements.out")),
                tags=parse_tags(read("tags.out")),
                config_text=read("config.cfg"),
                sightings=parse_sightings(read("sightings.out")),
                sidebar=read_bytes("sidebar.avi"),
            )
