"""The sensors that the harness drives: one entry for each of the program's
`Sensor` members, keyed by a configuration's `sensor` string. The table is
closed because the program's sensors are.

It imports nothing of the program: the window looks the member and the entry
point up by name on the system it builds.
"""

from __future__ import annotations

from typing import NamedTuple


class SensorSpec(NamedTuple):
    member: str  # the program's `Sensor` member
    track: str  # the `SlamSystem` entry point of one frame: (image[, second], timestamp=)
    second: str | None  # what `Session.second` holds: "depth", "right" (image), None (monocular)

    @property
    def metric(self) -> bool:
        """A second image gives depth: it fixes the map's scale, and one frame
        initializes the map. Without it the scale is free and the initializer
        takes two views."""
        return self.second is not None


SENSORS = {
    "rgbd": SensorSpec("RGBD", "track_rgbd", "depth"),
    "stereo": SensorSpec("STEREO", "track_stereo", "right"),
    "monocular": SensorSpec("MONOCULAR", "track_monocular", None),
}


def spec(sensor: str, named_in: str = "the configuration") -> SensorSpec:
    """The table's entry; a ValueError naming where the sensor was named and
    this file where it was looked for."""
    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r} of {named_in} is not in the table of slam_bench/sensors.py "
                         f"({', '.join(SENSORS)})")
    return SENSORS[sensor]
