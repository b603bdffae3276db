"""Faults planted under the port's timed path, for the tests and for the
readings of `correct` (readings.py --fault): each wraps a Simulation's own
step or vehicle, as a fault of the port would sit there.

  unchanged  the step hands its state on unchanged;
  half       half of the particles keep the poses they started from;
  altered    a measurement altered where the vehicle produces it (the
             capture the check reads sits outside the fault, as it sits
             outside the port's own vehicle);
  collapse   where the step resampled, the particle in the best slot is
             copied into every slot, ancestors with it."""

import torch


def unchanged(sim):
    def step(params, state, *args, **kwargs):
        return state

    sim._step_slam = step


def half(sim):
    inner = sim._step_slam

    def step(params, state, *args, **kwargs):
        out = inner(params, state, *args, **kwargs)
        p = out.pose.shape[0] // 2
        pose = torch.cat([out.pose[:p], state.pose[p:]])
        return out._replace(pose=pose)

    sim._step_slam = step


def altered(sim):
    inner = sim._vehicle_frame

    def vehicle(draws):
        noisy, z, mask, *rest = inner(draws)
        first = int(torch.nonzero(mask)[0, 0]) if bool(mask.any()) else 0
        z = z.clone()
        z[first, 0] += 10.0  # pixels
        z[first, -1] += 0.1  # metres of range
        return (noisy, z, mask, *rest)

    sim._vehicle_frame = vehicle


def collapse(sim):
    inner = sim._step_slam

    def step(params, state, *args, **kwargs):
        out = inner(params, state, *args, **kwargs)
        p = out.pose.shape[0]
        if not bool((out.logweight == out.logweight[0]).all()):
            return out
        slot = out.best.reshape(1).expand(p)
        return out._replace(pose=out.pose[slot], maps=type(out.maps)(*[leaf[slot] for leaf in out.maps]),
                            ancestor=out.ancestor[slot])

    sim._step_slam = step


FAULTS = {f.__name__: f for f in (unchanged, half, altered, collapse)}
