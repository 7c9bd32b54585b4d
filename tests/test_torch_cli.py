"""The port's command line, ``python -m soda_tpu_torch``.

On the CPU it runs with ``--device cpu`` (the kernels' plain versions)
and self-tests against the NumPy oracle, printing the JAX CLI's
``INFO: PASS!`` verdict; without it, on a machine with no GPU, it fails
rather than falling back. Flags of the JAX CLI that the port does not
have yet exit nonzero naming their ROADMAP item.
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
], ids=['blur', 'erosion-cr-greedy', 'denoise2d-coarse', 'jacobi2d-replicated'])
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
    (['--run', '--mesh', '2'], 'A9'),
    (['--run', '--backend', 'xla'], 'A2'),
    (['--run', '--backend', 'pallas'], 'A4'),
    (['--run', '--backend', 'sharded'], 'A9'),
], ids=lambda v: v if isinstance(v, str) else v[-2].lstrip('-') + '-' + v[-1])
def test_unported_flags_name_their_roadmap_item(flags, item, tmp_path,
                                                capsys):
  soda = tmp_path / 'blur.soda'
  soda.write_text(corpus.CORPUS['blur'])
  code, out = _main([str(soda), '--device', 'cpu', *flags], capsys)
  assert code != 0
  assert 'ROADMAP %s' % item in out.err


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
