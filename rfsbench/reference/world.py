"""World descriptor parsing and serialization and command-file parsing: the
port's own copy of monorfs_tpu.io.world (Util.cs:232-264,
SimulatedVehicle.cs:346-385, Vehicle.cs:503-522, FileParser.cs:263-274)."""

import dataclasses
from typing import List, Optional

import numpy as np


def parse_dictionary(descriptor: str):
    """Tab-indented key/children parser (Util.cs:232-264)."""
    out = {}
    key = None
    for line in descriptor.replace("\r\n", "\n").replace("\r", "\n").split("\n"):
        if not line.strip():
            continue
        if line[0] != "\t":
            key = line.strip()
            out[key] = []
        elif key is not None:
            out[key].append(line[1:])
    return out


@dataclasses.dataclass
class World:
    pose: np.ndarray  # initial vehicle state
    landmarks: np.ndarray  # [L, 3]
    measurer_params: Optional[np.ndarray]  # linear measurer descriptor

    @classmethod
    def parse(cls, descriptor: str) -> "World":
        d = parse_dictionary(descriptor)
        pose = np.array([float(v) for v in d["pose"][0].split()])
        mkey = "focal" if "focal" in d else ("params" if "params" in d else None)
        mparams = (
            np.array([float(v) for v in d[mkey][0].split()]) if mkey else None
        )
        landmarks = np.array(
            [[float(v) for v in line.split()] for line in d.get("landmarks", [])]
        ).reshape(-1, 3)
        return cls(pose=pose, landmarks=landmarks, measurer_params=mparams)

    @classmethod
    def from_file(cls, filename) -> "World":
        with open(filename) as f:
            return cls.parse(f.read())

    def serialize(self) -> str:
        out = "pose\n\t" + " ".join(_g6(v) for v in self.pose) + "\n"
        if self.measurer_params is not None:
            out += "params\n\t" + " ".join(_g6(v) for v in self.measurer_params) + "\n"
        out += "landmarks\n" + "".join(
            "\t" + " ".join(_g6(v) for v in lm) + "\n" for lm in self.landmarks
        )
        return out


def _g6(v):
    """C#'s "g6" float format."""
    return f"{float(v):.6g}"


def parse_commands(text: str) -> List[np.ndarray]:
    """One odometry reading per line, optionally followed by a SLAM/mapping
    switch flag and screenshot fields (FileParser.cs:263-274)."""
    return [
        np.array([float(v) for v in line.split()])
        for line in text.splitlines()
        if line.strip()
    ]
