"""actions.txt writer/reader (copy of activesplat_tpu/io/actions.py).

Format parity with the reference (src/dataloader/dataloader.py:255-263): one
integer Habitat pointnav action id per line (0 stop, 1 move_forward,
2 turn_left, 3 turn_right, 4 look_up, 5 look_down), written as the agent
steps; replayed by the coverage judge (scripts/judges/eval_actions.py:124-136).
"""

from __future__ import annotations

import os
from typing import List

ACTION_NAMES = ("stop", "move_forward", "turn_left", "turn_right", "look_up", "look_down")


class ActionLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "w")

    def append(self, action: int) -> None:
        action = int(action)
        assert 0 <= action < len(ACTION_NAMES), f"unknown action id {action}"
        self._fh.write(f"{action}\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def read_actions(path: str) -> List[int]:
    with open(path) as fh:
        return [int(line.strip()) for line in fh if line.strip()]


def action_name(action_id: int) -> str:
    return ACTION_NAMES[int(action_id)]
