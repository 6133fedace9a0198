"""The one traffic generator: a mix file's parameters to a stream of requests.

A mix (`mixes/<mix>.json`) names the driver that serves its requests and
their parameters. This generator reads only the arrival pattern: requests
go back to back in a closed loop (`"loop": "closed"`: the next is sent when
the last has returned), grouped in episodes of `episode_requests` (a body
started from rest, then stepped frame by frame) or independent (each its
own start). Each request carries a seed of its own, derived from the run's
`--seed`, the stream and its index, so a seed gives the same requests in
the same order, whatever the window's length.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, NamedTuple

import numpy as np

# the stream the set-up's warm-up requests come from: the same for every
# run, so that set-up does the same work whatever the seed
WARM_SEED = 20240917


class Request(NamedTuple):
    index: int      # in the stream
    episode: int    # the episode (an independent request is its own)
    step: int       # its place in the episode: 0 starts from rest
    seed: int       # its episode's seed: the draws of its start


def load(root: str, mix: str) -> dict:
    with open(os.path.join(root, "fembench", "mixes", mix + ".json")) as fh:
        spec = json.load(fh)
    if spec.get("loop", "closed") != "closed":
        raise ValueError(f"mix {mix}: only closed-loop traffic is generated")
    return spec


def derive(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed for item `index` of stream `stream` (0: the requests,
    1: the check's sample) of the run seed `seed` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), int(stream),
                                 int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def requests(spec: dict, seed: int, start: int = 0) -> Iterator[Request]:
    """The endless request stream of a mix for a seed, from index start."""
    per = int(spec.get("episode_requests", 1))
    i = start
    while True:
        ep, step = divmod(i, per)
        yield Request(i, ep, step, derive(seed, ep))
        i += 1
