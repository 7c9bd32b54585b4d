"""The port's command line, ``python -m soda_tpu_torch``.

On the CPU it runs with ``--device cpu`` (the kernels' plain versions)
and self-tests against the NumPy oracle, printing the JAX CLI's
``INFO: PASS!`` verdict; without it, on a machine with no GPU, it fails
rather than falling back. ``--backend xla`` (the whole-grid executor)
and ``--backend sharded`` (``--mesh`` over distinct visible devices)
pass there too. Flags of the JAX CLI that the port does not have yet
exit nonzero naming their ROADMAP item.
"""

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
], ids=['blur', 'erosion-cr-greedy', 'denoise2d-coarse', 'jacobi2d-replicated',
        'jacobi2d-xla', 'blur-sharded', 'blur-sharded-mesh-1',
        'denoise2d-sharded-preserve'])
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
    (['--compile-stats', '-'], 'A11'),
    (['--run', '--tune'], 'A11'),
    (['--run', '--kernel-opt', 'block_rows=8'], 'A11'),
    (['--run', '--backend', 'sharded', '--kernel-opt', 'tile=8'], 'A11'),
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
