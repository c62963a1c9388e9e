"""Device-simulation layer: memristor model, frame- and event-driven sims
(the port's counterpart of :mod:`nsof_tpu.device`)."""

from nsof_tpu_torch.device.model import (  # noqa: F401
    DEFAULT_PARAMS,
    DT,
    DeviceParams,
    conductance_to_gray,
    difference_voltage,
    dwdt,
    modulate_voltage,
    resistance_exp,
    resistance_linear,
    state_from_resistance,
    update_state,
)
from nsof_tpu_torch.device.frame_sim import (  # noqa: F401
    FrameSimConfig,
    compress_frames,
    simulate_frames,
    simulate_frames_fast,
)
from nsof_tpu_torch.device.event_sim import (  # noqa: F401
    BinnedEvents,
    EventSimConfig,
    bin_events,
    simulate_events,
    simulate_events_reference,
)
from nsof_tpu_torch.device.synthetic import generate_synthetic_events  # noqa: F401
from nsof_tpu_torch.device import io  # noqa: F401
