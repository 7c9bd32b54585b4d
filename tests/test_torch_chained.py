"""``chained`` and the sharded call: the loop, and the recorded path.

On a CUDA device ``chained`` records its calls in a CUDA graph and
``ShardedExecutor.fn`` its exchange and launches (backend/graphs.py);
the card's tests (tests/test_torch_gpu.py) hold the replays to the
uncaptured calls bit for bit. Here, on the CPU:

- ``chained`` keeps the results it gave before: the Python loop over
  ``executor.fn``, equal to the JAX package's ``chained`` (a jitted
  ``fori_loop``) within the reference threshold, and no replay;
- which path a call takes: none is recorded on the CPU, with an
  argument that requires grad, or inside another recording;
- the recorded paths' own logic (fixed buffers, the in-place halo
  exchange, crops, copies of the outputs) with the graph emulated: a
  "replay" copies the sources into the buffers and runs the recorded
  call again, writing into the recorded outputs. Bit for bit equal to
  the loop and to ``fn_eager``.
"""

import collections

import numpy as np
import pytest
import torch

from soda_tpu import chained as jax_chained
from soda_tpu import corpus as jax_corpus
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu_torch import api, corpus, get_executor, utils
from soda_tpu_torch.backend import graphs, reference
from soda_tpu_torch.parallel.mesh import Replicated, Shards
from soda_tpu_torch.parallel.spmd import ShardedExecutor
from soda_tpu_torch.testing import check_outputs, repeated_mesh

torch.set_num_threads(1)


def _bytes(tensor):
  """A tensor's bytes, so that equal NaNs compare equal."""
  return tensor.contiguous().view(torch.uint8)


def _walk(value):
  """The tensors of a recorded call's outputs."""
  if isinstance(value, torch.Tensor):
    yield value
  elif isinstance(value, dict):
    for v in value.values():
      yield from _walk(v)
  elif isinstance(value, np.ndarray):
    for v in value.flat:
      yield from _walk(v)
  elif isinstance(value, Shards):
    yield from _walk(value.tensors)
  else:
    for v in value:
      yield from _walk(v)


class EmulatedGraph:
  """``graphs.Captured`` on the CPU: recording runs ``call`` once with
  launches noted, as a capture does; a replay copies the sources into the
  buffers, runs ``call`` again and writes its results into the recorded
  outputs, where a graph's replay writes."""

  instances = []

  def __init__(self, call, buffers):
    self.call, self.buffers = call, list(buffers)
    held = collections.Counter()
    token = graphs._HELD.set(held)
    try:
      self.outputs = call()
    finally:
      graphs._HELD.reset(token)
    self.held = dict(held)
    EmulatedGraph.instances.append(self)

  def replay(self, sources):
    for buffer, source in zip(self.buffers, sources):
      buffer.copy_(source)
    for mine, fresh in zip(list(_walk(self.outputs)),
                           list(_walk(self.call()))):
      mine.copy_(fresh)
    return self.outputs


@pytest.fixture
def emulated(monkeypatch):
  """Record on the CPU: every call counts as capturable, graphs are
  emulated."""
  EmulatedGraph.instances = []
  monkeypatch.setattr(graphs, 'Captured', EmulatedGraph)
  monkeypatch.setattr(graphs, 'capturable',
                      lambda args: graphs.leaves(args) is not None)
  return EmulatedGraph.instances


@pytest.mark.parametrize('name', ['blur', 'jacobi2d', 'heat3d', 'sobel2d'])
def test_chained_on_the_cpu_is_the_loop(name):
  if name in ('blur', 'sobel2d'):  # one output of the input's type
    stencil = corpus.build(name, iterate=1)
  else:
    stencil = corpus.build(name)
  if len(stencil.output_names) != len(stencil.input_names) or (
      stencil.symbol_table[stencil.output_names[0]].np_dtype !=
      stencil.symbol_table[stencil.input_names[0]].np_dtype):
    with pytest.raises(Exception, match='matching types'):
      api.chained(get_executor(stencil, corpus.TEST_DIMS[name],
                               device='cpu'), 3)
    return
  shape = corpus.TEST_DIMS[name]
  ex = get_executor(stencil, shape, device='cpu')
  inputs = reference.make_test_inputs(stencil, shape)
  args = ex.prepare(inputs)
  run = api.chained(ex, 3)
  got = run(*args)
  want = args
  for _ in range(3):
    want = ex.fn(*want)
  assert all(torch.equal(g, w) for g, w in zip(got, want))
  assert run.replays == 0 and isinstance(run, api.Chained)
  jax_run = jax_chained(XlaExecutor(jax_corpus.build(name), shape), 3)
  jax_got = jax_run(*[inputs[n] for n in stencil.input_names])
  check_outputs(stencil, shape,
                dict(zip(stencil.output_names, got)),
                dict(zip(stencil.output_names,
                         [np.asarray(v) for v in jax_got])),
                name + ' chained vs jax')


def test_which_calls_are_recorded():
  x = torch.zeros(4, 8)
  assert not graphs.capturable((x,))  # the CPU
  assert not graphs.capturable((x.requires_grad_(),))
  assert not graphs.capturable((object(),))
  assert graphs.leaves((torch.zeros(2), object())) is None
  shards = Shards.of([torch.zeros(2, 8), torch.ones(2, 8)], (4, 8))
  rep = Replicated(torch.arange(3), [torch.device('cpu')])
  assert len(graphs.leaves((shards, rep))) == 3
  assert not graphs.capturable((shards, rep))


def test_signature_separates_what_a_recording_depends_on():
  x = torch.zeros(4, 8)
  keys = {graphs.signature((x,)), graphs.signature((x.t(),)),
          graphs.signature((x.to(torch.float64),)),
          graphs.signature((torch.zeros(4, 9),)),
          graphs.signature((Shards.of([x], (4, 8)),))}
  assert len(keys) == 5
  assert graphs.signature((x,)) == graphs.signature((torch.ones(4, 8),))


def test_count_launch_notes_launches_while_recording():
  class Kernel:
    launches = 0

  kernel = Kernel()
  graphs.count_launch(kernel)
  held = collections.Counter()
  token = graphs._HELD.set(held)
  try:
    graphs.count_launch(kernel)
    graphs.count_launch(kernel)
  finally:
    graphs._HELD.reset(token)
  assert kernel.launches == 1 and held[kernel] == 2


def test_grad_requiring_arguments_run_the_loop():
  """Autograd does not record through a replay: a call with an argument
  that requires grad runs the loop, and gradients flow through it (the
  card's test pins the rule on CUDA)."""
  stencil = corpus.build('jacobi2d')
  shape = corpus.TEST_DIMS['jacobi2d']
  ex = get_executor(stencil, shape, 'xla', device='cpu')
  run = api.chained(ex, 2)
  x = torch.rand(shape, requires_grad=True)
  assert not graphs.capturable((x,))
  torch.sum(run(x)[0]).backward()
  assert x.grad is not None and bool(torch.any(x.grad != 0))
  assert run.replays == 0


@pytest.mark.parametrize('name', ['jacobi2d', 'heat3d'])
def test_recorded_chain_equals_the_loop(name, emulated):
  stencil = corpus.build(name)
  shape = corpus.TEST_DIMS[name]
  ex = get_executor(stencil, shape, device='cpu')
  run = api.chained(ex, 4)
  rng = np.random.default_rng(5)
  xs = [torch.from_numpy(rng.random(shape, np.float32)) for _ in range(3)]
  first = run(xs[0])
  assert len(emulated) == 1 and run.replays == 0
  second = run(xs[1])
  kept = second[0].clone()
  third = run(xs[2])
  assert run.replays == 2 and len(emulated) == 1
  for x, got in zip(xs, (first, second, third)):
    assert torch.equal(_bytes(got[0]), _bytes(run.loop(x)[0]))
  # outputs are copies: a later replay leaves them as they were
  assert torch.equal(second[0], kept)
  assert second[0].data_ptr() != emulated[0].outputs[0].data_ptr()
  # another signature is another first call: the loop, which checks
  # the arguments as fn does (a view that is not contiguous is refused)
  with pytest.raises(utils.InputError, match='contiguous'):
    run(torch.from_numpy(rng.random(shape[::-1], np.float32)).permute(
        *reversed(range(len(shape)))))
  assert len(emulated) == 1


@pytest.mark.parametrize('name,mesh,inner,overrides', [
    ('blur', (4,), 'fused', {}),
    ('heat3d', (2, 2), 'fused', {}),
    ('jacobi2d', (4,), 'fused', {'border': 'preserve'}),
    ('denoise2d', (4,), 'grouped', {'cluster': 'coarse'}),
    ('jacobi2d', (2, 2), 'fused', {}),
], ids=['blur-4', 'heat3d-2x2', 'jacobi2d-preserve-4', 'denoise2d-grouped-4',
        'jacobi2d-2x2'])
def test_recorded_sharded_call_equals_the_eager_one(name, mesh, inner,
                                                    overrides, emulated):
  stencil = corpus.build(name, **overrides)
  shape = corpus.TEST_DIMS[name]
  ex = ShardedExecutor(stencil, shape, mesh=repeated_mesh('cpu', mesh),
                       inner=inner, device='cpu')
  assert not ex.recordable  # the CPU records nothing
  ex.recordable = True
  calls = []
  for seed in range(3):
    inputs = reference.make_test_inputs(stencil, shape, seed=seed)
    calls.append(ex.prepare(inputs, reference.make_test_params(stencil)))
  results = [ex.fn(*args) for args in calls]
  assert ex.replays == 2 and len(emulated) == 1
  for args, got in zip(calls, results):
    want = ex.fn_eager(*args)
    for g, w in zip(got, want):
      assert g.grid == w.grid
      assert all(torch.equal(_bytes(a), _bytes(b))
                 for a, b in zip(g.tensors.flat, w.tensors.flat))
