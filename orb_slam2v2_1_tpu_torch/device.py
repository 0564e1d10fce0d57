"""Where the port's entry points put their tensors.

Every entry point that creates tensors (`models.offline.track_sequence_rgbd`
on numpy frames, `utils.synthetic.make_room` / `orbit_frames`,
`models.map_state.empty_map` / `from_numpy`, `models.tracking.frame_from_numpy`)
takes `device=None` to mean the NVIDIA card and raises when there is none; a
caller that wants the CPU says `device="cpu"`. Nothing carries on on the CPU
by itself.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA card and
    raises RuntimeError when no card is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was given: "
            'the port runs on the card by default; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())
