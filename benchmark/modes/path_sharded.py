"""The path mode's frames through ``render_streaming_sharded`` over a
mesh of every card the cell asks for, from one process: the pixel stream
cut into one slice per card, each card's batch enqueued before any is
read back, the slices gathered and assembled on the host. Frame i's
renderer seed is the scene's ``rng_seed``, from which each card's
jump-separated seed follows. The check is the path mode's, with the
shard plan's slots and seeds."""

from __future__ import annotations

import dataclasses

from benchmark.modes import path


class Program(path.Program):
    def __init__(self, cell, seed, devices, spans):
        super().__init__(cell, seed, devices, spans)
        from ipu_ray_lib_tpu_torch.parallel.mesh import make_ray_mesh

        self.mesh = make_ray_mesh(devices)

    def render(self, frame_seed: int):
        from ipu_ray_lib_tpu_torch.parallel.mesh import (
            render_streaming_sharded)

        params = dataclasses.replace(self.params, rng_seed=frame_seed)
        return render_streaming_sharded(self.scene, params, self.mesh,
                                        chunk_slots=self.chunk, env=self.env)

    def release(self) -> None:
        super().release()
        self.mesh = None


def check(cell, seed, frames, device) -> dict:
    return path.check(cell, seed, frames, device, shards=cell.chips)


def reference(cell, seed, n_frames, device, control=False):
    return path.reference(cell, seed, n_frames, device, control,
                          shards=cell.chips)


compare = path.compare
