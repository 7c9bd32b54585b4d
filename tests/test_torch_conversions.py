"""Float -> integer conversions in range, on every CPU path.

C converts a float or double to an integer type by truncating toward
zero, and leaves the conversion undefined where the truncated value does
not fit the type (csrc/soda_stencil.cuh keeps such conversions to
programs that stay in range). There the NumPy oracle, the JAX executor
and the port answer differently: ROADMAP §C logs the difference by
decision. ``testing.gen_program`` never writes a float -> integer
conversion (floats reach integers only through comparisons), so this
file runs one program per integer type, each width the DSL has among
them (int12, uint6 and int40 too): ``o = T(f)`` of a float input and
``p = T(d)`` of a double one at a tap, on values whose truncation fits
T: fractions of either sign (truncated toward zero), negative values
into signed types, each type's extremes with a fraction past them, and
magnitudes over the type's range. The port's plain version
(``fused_stencil_plain``), the whole-grid executor, the printed program
(``--emit-torch``), the default kernel under the g++ emulation
(tests/torch_emulation.py) and the JAX ``XlaExecutor`` (x64) are each
equal to the oracle as numbers. Fault C7 (ROADMAP §C): the torch paths
gave 2**63 for every float in [2**63, 2**64) converted to uint64, as
torch's own float -> int64 conversion does; ``semantics.trunc_int64``
(and the printed program's ``_trunc_int64``) take such a value as its
bit pattern.
"""

import concurrent.futures
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import soda_tpu
from soda_tpu.backend.xla import XlaExecutor
from soda_tpu_torch import api, testing
from soda_tpu_torch.backend import reference
from soda_tpu_torch.backend.fused import fused_stencil_plain
from soda_tpu_torch.backend.tile_plan import make_tile_plan
from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
from soda_tpu_torch.codegen import torch_source
from soda_tpu_torch.ir.types import Type

from torch_emulation import compile_kernel, run_kernel

torch.set_num_threads(1)

# (type, least value, greatest value)
TYPES = (('int8', -2**7, 2**7 - 1), ('uint8', 0, 2**8 - 1),
         ('int12', -2**11, 2**11 - 1), ('uint6', 0, 2**6 - 1),
         ('int16', -2**15, 2**15 - 1), ('uint16', 0, 2**16 - 1),
         ('int32', -2**31, 2**31 - 1), ('uint32', 0, 2**32 - 1),
         ('int40', -2**39, 2**39 - 1), ('int64', -2**63, 2**63 - 1),
         ('uint64', 0, 2**64 - 1))
SHAPE = (12, 40)


def program(out_type: str) -> str:
  return '\n'.join([
      'kernel: conv', 'burst width: 64', 'unroll factor: 1', 'iterate: 1',
      'border: ignore', 'cluster: none', 'input dram 0 float: f(40, *)',
      'input dram 1 double: d',
      'output dram 2 %s: o(0, 0) = %s(f(0, 0))' % (out_type, out_type),
      'output dram 3 %s: p(0, 0) = %s(d(0, 1))' % (out_type, out_type)])


def in_range_values(lo: int, hi: int, dtype, seed: int) -> np.ndarray:
  """SHAPE values of ``dtype`` whose truncation toward zero lies in [lo,
  hi]: the extremes, with fractions that truncate back to them; zeros and
  fractions of either sign; then magnitudes 2**u, u uniform over the
  type's bits, each with a fraction and a sign (unsigned: at most a
  fraction below zero). A value that rounds past the range in ``dtype``
  becomes 0."""
  rng = np.random.default_rng(seed)
  cells = int(np.prod(SHAPE))
  special = [0.0, -0.0, 0.5, -0.5, 0.999, -0.999, 1.0, -1.0, 1.5, -1.5,
             float(hi), hi + 0.75, float(lo), lo - 0.75, lo + 0.5, hi - 0.5]
  bits = hi.bit_length()
  mags = np.floor(2.0 ** rng.uniform(0, bits, cells)) + rng.uniform(0, 1,
                                                                    cells)
  signs = np.where(rng.uniform(size=cells) < 0.5, -1.0, 1.0)
  values = mags * signs if lo < 0 else np.where(signs < 0, -mags % 1, mags)
  values[:len(special)] = special
  values = values.astype(dtype)
  wide = values.astype(np.float64)
  # (hi + 1 == 2**bits and lo are powers of two, exact in float64)
  fits = (np.trunc(wide) >= lo) & (np.trunc(wide) < 2.0 ** bits)
  return np.where(fits, values, dtype(0)).reshape(SHAPE)


def inputs_for(index: int):
  _, lo, hi = TYPES[index]
  return {'f': in_range_values(lo, hi, np.float32, 2 * index),
          'd': in_range_values(lo, hi, np.float64, 2 * index + 1)}


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
  """Each type's program's outputs from its emulated default kernel."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('needs g++')
  tmp = tmp_path_factory.mktemp('conversions')

  def run(index):
    stencil = api.build_stencil(program(TYPES[index][0]))
    plan = make_tile_plan(stencil, SHAPE)
    exe = compile_kernel(gxx, tmp, index, plan, 1)
    outs = run_kernel(exe, tmp, stencil, [inputs_for(index)], {}, False)
    return {n: o.reshape(SHAPE) for n, o in zip(stencil.output_names, outs)}

  with concurrent.futures.ThreadPoolExecutor(4) as pool:
    return list(pool.map(run, range(len(TYPES))))


def test_values_stay_in_range_and_reach_both_ends():
  for index, (name, lo, hi) in enumerate(TYPES):
    for key, x in inputs_for(index).items():
      t = np.trunc(x.astype(np.float64))
      assert t.min() >= lo and t.max() < 2.0 ** hi.bit_length(), (name, key)
      assert (t == lo).any() or key == 'f', (name, key)
      frac = x.astype(np.float64) - t
      assert (frac != 0).sum() > x.size // 4, (name, key)
      if lo < 0:
        assert ((x < 0) & (frac != 0)).any(), (name, key)


@pytest.mark.parametrize('index', range(len(TYPES)),
                         ids=[t[0] for t in TYPES])
def test_in_range_conversion_matches_oracle_on_every_path(emulated, index):
  name = TYPES[index][0]
  text = program(name)
  stencil = api.build_stencil(text)
  assert stencil.symbol_table['o'] == Type(name)
  inputs = inputs_for(index)
  want = reference.run(stencil, inputs)
  # truncation toward zero, as C converts (o reads f at its own cell)
  np.testing.assert_array_equal(
      want['o'].astype(np.float64),
      np.trunc(inputs['f'].astype(np.float64)))
  tensors = [torch.from_numpy(np.ascontiguousarray(inputs[n]))
             for n in stencil.input_names]
  plain = dict(zip(stencil.output_names, fused_stencil_plain(stencil,
                                                             tensors)))
  whole = WholeGridExecutor(stencil, SHAPE, device='cpu')(inputs)
  module = types.ModuleType('generated_stencil')
  exec(compile(torch_source.generate(stencil, SHAPE), '<generated>', 'exec'),
       module.__dict__)
  printed = module.compute(*tensors)
  with jax.enable_x64(True):
    jax_got = {k: np.asarray(v) for k, v in XlaExecutor(
        soda_tpu.build_stencil(text), SHAPE)(inputs).items()}
  for path, got in (('plain', plain), ('whole-grid', whole),
                    ('printed', printed),
                    ('emulated kernel', emulated[index]), ('jax', jax_got)):
    testing.check_exact(stencil, SHAPE, got, want, '%s %s' % (name, path),
                        values=True)
