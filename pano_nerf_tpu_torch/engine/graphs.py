"""CUDA graphs: the port's counterpart of the JAX package's `jax.jit`.

The JAX package never runs its model eagerly: the train step is jitted,
`train.steps_per_call` of them under one `lax.scan`
(pano_nerf_tpu/engine/system.py `_jit_steps`), and the panorama render is
one jitted `lax.map` over its chunks (`_chunked`, `make_render_image`).
On the card a step run op by op costs more host time (Python, autograd,
~1,200 launches) than device time, so the port captures the same units
into CUDA graphs and replays them: the train step (one step, or K in one
graph) and the eval chunk (`engine/system.py`).

`CapturedGraph` captures a body on its first call and replays it after:

- *Warm-up.* A capture needs the body to have run first (the kernels'
  nvcc build and library load, cuBLAS workspaces, Adam's lazily created
  state), on the side stream the capture uses. Those runs are real: they
  launch kernels (counted, and also noted in `counters.WARMUP`) and
  change the state. `snapshot()` is taken before them and the restore it
  returns is called after the warm-up and after the capture, so that the
  first replay starts where the first eager step would have.
- *Random numbers.* The generators the body draws from are registered
  with the graph: every replay draws what the eager ops would have drawn
  from the generator's state at that moment, and advances it as they
  would (`torch.cuda.CUDAGraph.register_generator_state`).
- *Launch counts.* The kernel wrappers count at capture, which launches
  nothing: the capture's counts are taken back and added at every replay.
- *Failures.* Capture and replay raise; nothing falls back to eager.

What a graph reads and writes are the tensors the capture saw: inputs are
copied into them before a replay, outputs are overwritten by the next one,
and a state whose tensors are replaced (`Optimizer.load_state_dict`) needs
a new capture.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from pano_nerf_tpu_torch.kernels import counters

WARMUP_RUNS = 3


class CapturedGraph:
    def __init__(self, body: Callable[[], Any],
                 warmup: Optional[Callable[[], Any]] = None,
                 snapshot: Optional[Callable[[], Callable[[], None]]] = None,
                 generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.warmup = body if warmup is None else warmup
        self.snapshot = snapshot
        self.generators = tuple(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}
        self.replays = 0

    def __call__(self) -> Any:
        if self.graph is None:
            self._capture()
        self.graph.replay()
        counters.add_launch_counts(self.launches)
        self.replays += 1
        return self.outputs

    def _capture(self) -> None:
        restore = self.snapshot() if self.snapshot is not None else None
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        before = counters.launch_counts()
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.warmup()
        main.wait_stream(side)
        counters.note_warmup(_minus(counters.launch_counts(), before))
        if restore is not None:
            restore()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = counters.launch_counts()
        with torch.cuda.graph(graph, stream=side):
            outputs = self.body()
        self.launches = _minus(counters.launch_counts(), before)
        counters.add_launch_counts(self.launches, times=-1)
        if restore is not None:
            restore()
        self.graph, self.outputs = graph, outputs


def _minus(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}
