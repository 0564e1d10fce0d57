"""Faults planted in the program's timed path, one at a time, for the tests
that must see the correctness check come out false."""

from orb_slam2v2_1_tpu_torch.models import frontend
from orb_slam2v2_1_tpu_torch.ops import orb


def _frozen(fn):
    """Tracking that returns the previous frame's pose as the frame's: a
    step that leaves its state unchanged."""
    def track(state, cur, last, *a, **k):
        res = fn(state, cur, last, *a, **k)
        return res._replace(pose=last.pose, frame=res.frame._replace(pose=last.pose))
    return track


def _flip_bits(fn):
    """Descriptors altered where they are produced: the first word inverted."""
    def extract(img, config=orb.OrbConfig()):
        f = fn(img, config)
        desc = f.desc.clone()
        desc[:, 0] = ~desc[:, 0]
        return f._replace(desc=desc)
    return extract


def _half_dropped(fn):
    """Half of the keypoints of every frame left out."""
    def extract(img, config=orb.OrbConfig()):
        f = fn(img, config)
        valid = f.valid.clone()
        valid[::2] = False
        return f._replace(valid=valid)
    return extract


def _points_moved(fn):
    """Map points altered where local mapping makes them: every mapping
    round returns the map's points 5% farther from the world origin."""
    def mapping(state, *a, **k):
        out = fn(state, *a, **k)
        return (out[0]._replace(mp_pos=out[0].mp_pos * 1.05),) + tuple(out[1:])
    return mapping


# name -> (module, attribute, wrapper of the attribute's function)
FAULTS = {
    "state_unchanged": (frontend, "track_frame_impl", _frozen),
    "descriptor_altered": (orb, "extract_orb", _flip_bits),
    "half_the_keypoints_left_out": (orb, "extract_orb", _half_dropped),
    "map_points_altered": (frontend, "mapping_pipeline", _points_moved),
}
