"""Autotuning — the port of ``deepspeed_tpu/autotuning``: the roofline-seeded
offline config search over training AND serving knobs, scored by the
bench's own metrics (``autotuner.py``), and the online controller that
retunes a live serving engine under traffic drift (``controller.py``)."""
from .autotuner import (  # noqa: F401
    Autotuner,
    Trial,
    autotune_model,
    autotune_serving,
    leaderboard,
    write_leaderboard,
)
from .controller import (  # noqa: F401
    OnlineController,
    attach_controller,
    roofline_rebuild_scorer,
)
from .roofline import RooflineConstants  # noqa: F401
from .space import Knob, SearchSpace, serving_space, training_space  # noqa: F401
from .trial import ServeTrialRunner, ServeWorkload, TrainTrialRunner  # noqa: F401
