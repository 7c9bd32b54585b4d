"""The port's command line, ``python -m soda_tpu_torch``.

On the CPU it runs with ``--device cpu`` (the kernels' plain versions)
and self-tests against the NumPy oracle, printing the JAX CLI's
``INFO: PASS!`` verdict; without it, on a machine with no GPU, it fails
rather than falling back. ``--backend xla`` (the whole-grid executor)
and ``--backend sharded`` (``--mesh`` over distinct visible devices)
pass there too, and so do runs with the fused kernel's modes and layout
keys (``--kernel-opt``, the JAX CLI's own example among them) and
``--compile-stats`` (the plan's fields; the
card's are null there). ``--tune`` needs the card. Flags of the JAX CLI
that the port does not have yet exit nonzero naming their ROADMAP item.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from soda_tpu_torch import corpus, sodac

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(module, args, tmp_path, name='blur'):
  soda = tmp_path / ('%s.soda' % name)
  soda.write_text(corpus.CORPUS[name])
  env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS='cpu')
  return subprocess.run([sys.executable, '-m', module, str(soda), *args],
                        capture_output=True, text=True, cwd=str(REPO),
                        env=env, timeout=300)


@pytest.mark.parametrize('name,flags', [
    ('blur', []),
    ('erosion', ['--computation-reuse', 'greedy']),
    ('denoise2d', ['--cluster', 'coarse']),
    ('jacobi2d', ['--backend', 'replicated', '--replication-factor', '2']),
    ('jacobi2d', ['--backend', 'xla']),
    ('blur', ['--backend', 'sharded']),
    ('blur', ['--backend', 'sharded', '--mesh', '1']),
    ('denoise2d', ['--backend', 'sharded', '--border', 'preserve']),
    ('blur', ['--kernel-opt', 'stream_loop=peel']),
    ('jacobi3d', ['--kernel-opt', 'stream_loop=peel', '--kernel-opt',
                  'prefetch=3', '--kernel-opt', 'block_rows=4']),
    ('heat3d', ['--kernel-opt', 'dma_split=2', '--kernel-opt', 'out_dma=true']),
    ('blur', ['--backend', 'sharded', '--kernel-opt', 'stream_loop=peel']),
    ('jacobi2d', ['--backend', 'replicated', '--replication-factor', '2',
                  '--kernel-opt', 'out_dma=true']),
    ('denoise2d', ['--cluster', 'coarse', '--kernel-opt', 'tile=8,32']),
    # the JAX CLI's own --kernel-opt example (soda_tpu/sodac.py:112-113)
    ('erosion', ['--computation-reuse', 'greedy', '--kernel-opt',
                 'stage_mode=value', '--kernel-opt', 'shift_mode=roll',
                 '--kernel-opt', 'transpose_lanes=on']),
    ('jacobi3d', ['--kernel-opt', 'compute_chunk=2', '--kernel-opt',
                  'block_rows=4']),
    ('blur', ['--backend', 'sharded', '--kernel-opt', 'stage_mode=value',
              '--kernel-opt', 'lane_shift=slice']),
], ids=['blur', 'erosion-cr-greedy', 'denoise2d-coarse', 'jacobi2d-replicated',
        'jacobi2d-xla', 'blur-sharded', 'blur-sharded-mesh-1',
        'denoise2d-sharded-preserve', 'blur-kernel-opt-peel',
        'jacobi3d-kernel-opt-peel-prefetch3', 'heat3d-kernel-opt-split-out-dma',
        'blur-sharded-kernel-opt-peel', 'jacobi2d-replicated-kernel-opt',
        'denoise2d-coarse-kernel-opt-tile', 'erosion-kernel-opt-jax-example',
        'jacobi3d-kernel-opt-chunk', 'blur-sharded-kernel-opt-slice'])
def test_run_passes_on_the_cpu(name, flags, tmp_path):
  shape = ','.join(map(str, corpus.TEST_DIMS[name]))
  r = _run('soda_tpu_torch', ['--run', '--device', 'cpu', '--shape', shape,
                              *flags], tmp_path, name)
  assert r.returncode == 0, r.stderr + r.stdout
  assert r.stdout.splitlines()[0] == 'INFO: PASS!'
  assert 'device=cpu' in r.stdout


def test_same_verdict_as_the_jax_cli(tmp_path):
  args = ['--run', '--shape', '40,64', '--cluster', 'coarse']
  port = _run('soda_tpu_torch', args + ['--device', 'cpu'], tmp_path)
  jax = _run('soda_tpu', args + ['--backend', 'pallas'], tmp_path)
  assert port.returncode == jax.returncode == 0, port.stderr + jax.stderr
  assert port.stdout.splitlines()[0] == jax.stdout.splitlines()[0] == \
      'INFO: PASS!'


def _main(args, capsys):
  code = sodac.main(args)
  return code, capsys.readouterr()


def test_invalid_program_exits_1(tmp_path, capsys):
  bad = tmp_path / 'bad.soda'
  bad.write_text('kernel: broken\n')
  code, out = _main([str(bad), '--run', '--device', 'cpu'], capsys)
  assert code == 1
  assert 'invalid SODA program' in out.err and len(out.err.splitlines()) == 1


@pytest.mark.parametrize('flags,item', [
    (['--emit-jax', '-'], 'A10'),
    (['--emit-numpy', '-'], 'A10'),
    (['--estimate', '-'], 'A12'),
    (['--model-file', 'm.json'], 'A12'),
    (['--run', '--backend', 'pallas'], 'A4'),
], ids=lambda v: v if isinstance(v, str) else v[-2].lstrip('-') + '-' + v[-1])
def test_unported_flags_name_their_roadmap_item(flags, item, tmp_path,
                                                capsys):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--device', 'cpu', *flags], capsys)
  assert code != 0
  assert 'ROADMAP %s' % item in out.err


def test_same_verdict_as_the_jax_cli_sharded(tmp_path):
  # the JAX CLI shards over the conftest's virtual devices, the port's
  # over the one visible CPU device
  args = ['--run', '--shape', '64,32', '--backend', 'sharded']
  port = _run('soda_tpu_torch', args + ['--device', 'cpu'], tmp_path,
              'jacobi2d')
  jax = _run('soda_tpu', args, tmp_path, 'jacobi2d')
  assert port.returncode == jax.returncode == 0, port.stderr + jax.stderr
  assert port.stdout.splitlines()[0] == jax.stdout.splitlines()[0] == \
      'INFO: PASS!'


@pytest.mark.parametrize('flags,message', [
    (['--backend', 'sharded', '--mesh', '2'],
     '--mesh 2 needs 2 distinct cpu devices, but 1 is visible'),
    (['--backend', 'sharded', '--mesh', '2,2'],
     '--mesh 2,2 needs 4 distinct cpu devices, but 1 is visible'),
    (['--backend', 'sharded', '--mesh', '1,1,1'], 'one or two positive'),
    (['--mesh', '1'], '--mesh applies to --backend sharded'),
    (['--backend', 'xla', '--kernel-opt', 'block_rows=8'],
     'the xla backend has no such knobs'),
], ids=['mesh-2', 'mesh-2x2', 'mesh-3d', 'mesh-without-sharded',
        'xla-kernel-opt'])
def test_mesh_and_backend_errors_exit_1(flags, message, tmp_path, capsys):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--run', '--device', 'cpu', '--shape', '40,64',
                     *flags], capsys)
  assert code == 1
  assert message in out.err and 'PASS' not in out.out


@pytest.mark.parametrize('flags,message', [
    (['--kernel-opt', 'bogus=1'], "unknown --kernel-opt key 'bogus'"),
    (['--kernel-opt', 'shift_mode=roll', '--kernel-opt', 'stage_mode=vmem'],
     'shift_mode=roll requires stage_mode=value'),
    (['--kernel-opt', 'narrow=sometimes'], 'narrow must be auto|on|off'),
    (['--kernel-opt', 'stream_loop'], 'expects KEY=VALUE'),
    (['--kernel-opt', 'stream_loop=peel', '--tune'],
     '--kernel-opt and --tune are mutually exclusive'),
    (['--kernel-opt', 'stream_loop=sometimes'], 'stream_loop must be'),
    (['--kernel-opt', 'prefetch=3'], 'needs stream_loop'),
    (['--kernel-opt', 'dma_split=2'], 'dma_split requires a 3-D'),
    (['--tune'], '--tune times the kernel on the card'),
    (['--tune', '--device', 'cuda', '--backend', 'xla'],
     'applies to --backend auto or fused'),
], ids=['unknown-key', 'layout-key-shift-mode', 'layout-key-narrow',
        'no-value', 'with-tune', 'bad-value', 'prefetch-alone', 'split-2d',
        'tune-on-cpu', 'tune-xla'])
def test_kernel_opt_and_tune_errors_exit_1(flags, message, tmp_path, capsys):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  args = [str(soda), '--run', '--shape', '40,64', *flags]
  if '--device' not in flags:
    args += ['--device', 'cpu']
  code, out = _main(args, capsys)
  assert code == 1, out
  assert message in out.err and 'PASS' not in out.out


def test_tune_without_a_gpu_exits_1(tmp_path, capsys):
  if torch.cuda.is_available():
    pytest.skip('a CUDA device exists here')
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--run', '--tune', '--shape', '40,64'],
                    capsys)
  assert code == 1 and 'CUDA device' in out.err and 'PASS' not in out.out


def test_kernel_opt_prints_the_kernel_config(tmp_path):
  r = _run('soda_tpu_torch', ['--run', '--device', 'cpu', '--shape', '64,64',
                              '--kernel-opt', 'stream_loop=peel',
                              '--kernel-opt', 'block_rows=8'], tmp_path)
  assert r.returncode == 0, r.stderr
  assert r.stdout.splitlines()[0] == 'INFO: PASS!'
  assert 'Kernel config: peel, tile (8, 64)' in r.stdout


@pytest.mark.parametrize('flags,kernels', [
    ([], 1),
    (['--cluster', 'coarse'], 2),
    (['--kernel-opt', 'stream_loop=peel'], 1),
])
def test_compile_stats_on_the_cpu(flags, kernels, tmp_path):
  out = tmp_path / 'stats.json'
  r = _run('soda_tpu_torch', ['--compile-stats', str(out), '--device', 'cpu',
                              '--shape', '1024,2048', *flags], tmp_path)
  assert r.returncode == 0, r.stderr
  stats = json.loads(out.read_text())
  assert len(stats['kernels']) == kernels and 'null' in stats['note']
  for kernel in stats['kernels']:
    assert kernel['registers'] is None and kernel['ctas'] > 0
  r = _run('soda_tpu_torch', ['--compile-stats', '-', '--run', '--device',
                              'cpu', '--shape', '64,64', *flags], tmp_path)
  assert r.returncode == 0, r.stderr
  assert 'INFO: PASS!' in r.stdout
  assert json.loads(r.stdout[:r.stdout.index('INFO:')])['device'] == 'cpu'


def test_no_gpu_is_no_cpu_fallback(tmp_path, capsys):
  if torch.cuda.is_available():
    pytest.skip('a CUDA device exists here')
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--run', '--shape', '40,64'], capsys)
  assert code != 0
  assert 'no CUDA device' in out.err
  assert 'PASS' not in out.out


def test_bench_needs_the_card(tmp_path, capsys):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--run', '--bench', '--device', 'cpu'],
                    capsys)
  assert code == 1 and '--device cuda' in out.err


def test_emit_dot(tmp_path, capsys):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--emit-dot', '-'], capsys)
  assert code == 0
  assert out.out.startswith('digraph') and 'blur_x' in out.out
