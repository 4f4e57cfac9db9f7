"""Carry a live SLAM state from the JAX package over to the port.

``yag_slam_tpu.slam.GraphSlam.serialize()`` returns a dict of Python and
numpy values only (scans, edges, running window, matcher configs, gates);
it is this system's counterpart of model weights.  This module turns it
into a port :class:`~yag_slam_tpu_torch.slam.graph_slam.GraphSlam` that
continues the run on a torch device.  It does not import JAX.
"""
from __future__ import annotations

import torch

from yag_slam_tpu_torch._device import DEFAULT_DEVICE
from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

_STATE_KEYS = (
    "scans", "edges", "running_scans", "seq_matcher_config",
    "loop_matcher_config", "scan_buffer_len", "loop_search_dist",
    "loop_search_min_chain_size", "min_response_coarse", "min_response_fine",
)


def graph_slam_from_state(state: dict, *, device=DEFAULT_DEVICE, dtype=torch.float32) -> GraphSlam:
    """Port GraphSlam rebuilt from a JAX-package ``GraphSlam.serialize()``
    dict, with its matchers on `device` in `dtype`."""
    missing = [k for k in _STATE_KEYS if k not in state]
    if missing:
        raise ValueError(f"not a GraphSlam state: missing {missing}")
    return GraphSlam.deserialize(state, device=device, dtype=dtype)
