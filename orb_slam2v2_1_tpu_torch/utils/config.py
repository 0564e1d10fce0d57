"""Camera + system configuration.

A copy of the JAX package's `utils/config.py` (pure Python; importing the
reference's module would load JAX). Replaces the reference's OpenCV-YAML settings parsing
(src/Tracking.cc:46-150 reading config/Asus.yaml) with a plain dataclass +
a YAML-subset loader (no external yaml dependency required; the standard
settings files used by the reference are flat key: value documents).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # Camera intrinsics (pinhole) + distortion (k1 k2 p1 p2 k3).
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 0.0  # baseline x fx (stereo/RGB-D); 0 => monocular
    th_depth: float = 40.0  # close/far stereo point threshold (ThDepth)
    depth_map_factor: float = 5000.0  # TUM depth png scale
    # ORB extractor (config/Asus.yaml ORBextractor block).
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    # Map capacities (static shapes).
    max_keyframes: int = 256
    max_map_points: int = 32768

    @property
    def K(self):
        return (self.fx, self.fy, self.cx, self.cy)

    @property
    def dist(self):
        return (self.k1, self.k2, self.p1, self.p2, self.k3)


_KEYMAP = {
    "Camera.fx": "fx",
    "Camera.fy": "fy",
    "Camera.cx": "cx",
    "Camera.cy": "cy",
    "Camera.k1": "k1",
    "Camera.k2": "k2",
    "Camera.p1": "p1",
    "Camera.p2": "p2",
    "Camera.k3": "k3",
    "Camera.fps": "fps",
    "Camera.bf": "bf",
    "Camera.width": "width",
    "Camera.height": "height",
    "ThDepth": "th_depth",
    "DepthMapFactor": "depth_map_factor",
    "ORBextractor.nFeatures": "n_features",
    "ORBextractor.nLevels": "n_levels",
    "ORBextractor.scaleFactor": "scale_factor",
    "ORBextractor.iniThFAST": "fast_threshold",
    "ORBextractor.minThFAST": "fast_min_threshold",
}


def load_settings(path: str | Path) -> SlamConfig:
    """Parse a flat `Key: value` settings file (the reference's YAML style)."""
    values = {}
    for line in Path(path).read_text().splitlines():
        line = line.split("#")[0].strip()
        m = re.match(r"([\w.]+)\s*:\s*([-\d.eE+]+)", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key in _KEYMAP:
            field = _KEYMAP[key]
            typ = SlamConfig.__dataclass_fields__[field].type
            values[field] = int(float(val)) if typ == "int" else float(val)
    return SlamConfig(**values)


# Ready-made dataset configs (intrinsics from the standard public
# calibrations the reference ships in config/).
TUM_FR1 = SlamConfig(
    fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
    k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
    depth_map_factor=5000.0,
)
KITTI_00 = SlamConfig(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
    width=1241, height=376, fps=10.0, bf=386.1448, n_features=2000,
)
EUROC = SlamConfig(
    fx=435.2046959714599, fy=435.2046959714599, cx=367.4517211914062,
    cy=252.2008514404297, width=752, height=480, fps=20.0, bf=47.90639384423901,
)
