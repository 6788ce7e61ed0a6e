"""Door, lift and exit scenarios on `:test:` level 0 (from tests/test_sim.py),
shared by the JAX-parity tests (tests/test_torch_sim.py) and the card tests
(tests/test_torch_cuda.py, which import no JAX).

name: (pos, yaw or None, the action held, ticks). "back" holds movement
(0, 1); the others hold that action's flag.
"""

import numpy as np

SCENARIOS = {
    "door_push": ([-2.56, 0.33, -5.9], None, "push", 1),
    "exit_switch": ([-2.56, 0.68, -14.7], None, "push", 1),
    "lift_walkover": ([-2.56, 0.66, -12.9], None, "back", 40),
    "push_out_of_range": ([-2.56, 0.33, -7.5], float(np.pi), "push", 1),
    "shoot_door": ([-2.56, 0.33, -5.9], None, "shoot", 1),
}
FIRING = ("door_push", "exit_switch", "lift_walkover")  # the scenarios that fire
