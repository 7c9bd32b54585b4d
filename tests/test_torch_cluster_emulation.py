"""The two thread-block-cluster kernels' CUDA text, run on the CPU
through a g++ emulation.

There is no nvcc without a card, so ``csrc/probe_narrow.cu``
(``strip_cluster``, exp24's indep10: independent phases with cross taps)
and ``csrc/probe_chain.cu`` (``chain_chunk_cluster``, exp24's chunked
bodies) are compiled with g++ under AddressSanitizer and UBSan against
the emulation of tests/test_torch_narrow_emulation.py's prelude: a
cluster launch (``cudaLaunchKernelEx`` with cluster dimensions) runs its
8 or 16 CTAs at once, each CTA host threads with a barrier of their own
and its shared memory a buffer of the launch's size filled with a
non-zero pattern, each warp 32 of them meeting at every ``__syncwarp`` and ``__shfl_sync``;
``barrier.cluster`` arrive and wait as a barrier across the cluster's
threads in halves (two arrivals without a wait, or a wait without an
arrival, abort); ``mapa`` / ``ld.shared::cluster`` read another CTA's
buffer, in bounds. A read of another CTA's shared memory made after the
reader's a-th arrival, where that CTA leaves after its a-th wait or
sooner (it may be gone), aborts the launch. Each source is built with
small instantiations in place of the card's (``SODA_CLUSTER_FORMS``:
bands of 16 rows of 64 words; ``SODA_CHUNK_FORMS``), so the bodies run
on small blocks with the card's distances: every cluster body bit for
bit against its plain version and (the strip bodies) the strip kernel's
grid-barrier form at 1, 2 and 5 iterations; the plans strip_cluster
refuses are those ``NarrowBody.cluster`` sends to the strip kernel; a
source whose kernel lost its exit barrier aborts. The card runs the same
text (tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses
import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from soda_tpu_torch.experiments import narrow, probes
from test_torch_narrow_emulation import PRELUDE, emulated_source

CSRC = (pathlib.Path(__file__).resolve().parents[1] / 'soda_tpu_torch' /
        'csrc')
FLAGS = ['-std=c++20', '-O1', '-g', '-pthread', '-fsanitize=address,undefined',
         '-fno-sanitize-recover=all', '-Wall', '-Wno-unused-function',
         '-Wno-unused-variable', '-Wno-unused-but-set-variable']
# strip_cluster's small bands: the card's 16 rows, of 64 words (a CTA of
# two warps)
STRIP_ROWS, STRIP_WORDS = 16, 64
STRIP_FORMS = '#define SODA_CLUSTER_FORMS(X) X(%d, %d)\n' % (STRIP_ROWS,
                                                           STRIP_WORDS)
# chain_chunk_cluster's small chunks: 32 rows x 64 lanes (two warps,
# bands of 16 rows), 24 rows x 32 lanes (one warp: the edge lanes wrap
# into the warp itself; bands of 12 rows, the margin from two bands)
CHUNK_FORMS = '#define SODA_CHUNK_FORMS(X) X(32, 64) X(24, 32)\n'
CHUNK_PRELUDE = r'''
#include <cmath>
struct alignas(16) int4 { int x, y, z, w; };
static int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
static float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
// the old chunk kernel's cooperative launch is not emulated here
static cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3,
                                               void**, size_t, cudaStream_t) {
  return cudaErrorInvalidValue;
}
'''
_INDEP10 = narrow.EXP24_SHIFT['indep10']
# (name, body, small shape): indep10 on C bands of 16 rows by 64 words
# (C = 16, 8, 2 and 1 CTAs: the last band's margin is the first band's
# rows, its own with one), the card's distances; two independent phases
# of other taps, one without cross taps
STRIP_CASES = tuple(
    ('indep10_%dctas' % (rows // STRIP_ROWS), _INDEP10, (rows, STRIP_WORDS))
    for rows in (256, 128, 32, 16)) + (
        ('two_phases', dataclasses.replace(
            _INDEP10, phases=((1, (3, 5, 1), (8, 2)), (1, (7,), ()))),
         (64, STRIP_WORDS)),)
# (chunk rows, lane tile, block): 8 and 16 CTAs (bands of half a chunk),
# two chunks and more
CHUNK_CASES = ((32, 64, (64, 128)), (24, 32, (96, 64)))


# each kernel at two iterations (indep10's plan, form 6, op 0: MinI32; a
# chunk of 32 x 64 lanes)
EXIT_BARRIERS = {
    'strip': ('\n  // the exit barrier: no CTA leaves while another may read '
              'its rows\n  if (ex) {\n    cluster_arrive();\n'
              '    cluster_wait();\n  }\n',
              [6, 0, 128, 64, 4, '{in}', '{out}', 14, 1, 1, 5, 1, 2, 4, 8,
               3, 5, 1, 2, 4, 8, 3, 1, 2]),
    'chunk': ('\n  // the exit barrier: no CTA leaves while another may read '
              'its rows\n  if (n > 1) {\n    cluster_arrive();\n'
              '    cluster_wait();\n  }\n',
              [32, 64, 64, 256, '{in}', '{out}', 1, 2]),
}


def chain_source() -> str:
  """probe_chain.cu with its launches rewritten for the emulation (the
  element-wise kernels' ordinary launch; the cluster launch is the
  prelude's ``cudaLaunchKernelEx``)."""
  text = (CSRC / 'probe_chain.cu').read_text()
  text = text.replace('#include <cooperative_groups.h>\n', '')
  text = text.replace('#include <cuda_runtime.h>\n', '')
  text = text.replace('extern __shared__ int w[];',
                      'int* w = reinterpret_cast<int*>(soda_emu_smem);')
  text = text.replace(
      'extern __shared__ __align__(16) unsigned char smem_raw[];',
      'unsigned char* smem_raw = soda_emu_smem;')
  text, ordinary = re.subn(
      r'(\w+<\w+>)<<<([^>]*)>>>\((.*?)\);',
      r'soda_emu_launch(false, \2, [=]() { \1(\3); });', text, flags=re.S)
  assert ordinary == 1, ordinary
  return PRELUDE + CHUNK_PRELUDE + CHUNK_FORMS + text


def strip_source() -> str:
  return STRIP_FORMS + emulated_source()


# argv: form op rows cols elem_bytes in out n_args args... n_iters ns...;
# one launch an n, its output appended to `out`, "status grid" a line
STRIP_MAIN = r'''
int main(int argc, char** argv) {
  int q = 1;
  const int form = atoi(argv[q++]), op = atoi(argv[q++]);
  const int rows = atoi(argv[q++]), cols = atoi(argv[q++]);
  const size_t bytes = static_cast<size_t>(rows) * cols * atoi(argv[q++]);
  const char* in = argv[q++];
  const char* out = argv[q++];
  std::vector<int> args(atoi(argv[q++]));
  for (int& a : args) a = atoi(argv[q++]);
  std::vector<long long> ns(atoi(argv[q++]));
  for (long long& n : ns) n = atoll(argv[q++]);
  std::vector<unsigned char> x(bytes), y(bytes), t(bytes);
  FILE* f = fopen(in, "rb");
  if (fread(x.data(), 1, bytes, f) != bytes) return 2;
  fclose(f);
  f = fopen(out, "wb");
  for (long long n : ns) {
    int ctas = 0;
    const int status = probe_narrow_launch(
        form, op, args.data(), static_cast<int>(args.size()), rows, cols,
        rows, cols, x.data(), nullptr, y.data(), t.data(), n, nullptr,
        &ctas);
    printf("%d %d\n", status, ctas);
    fwrite(y.data(), 1, bytes, f);
  }
  fclose(f);
  return 0;
}
'''
# argv: k_rows lane_tile rows cols in out n_iters ns...
CHUNK_MAIN = r'''
int main(int argc, char** argv) {
  int q = 1;
  const int k = atoi(argv[q++]), w = atoi(argv[q++]);
  const int rows = atoi(argv[q++]), cols = atoi(argv[q++]);
  const size_t cells = static_cast<size_t>(rows) * cols;
  const char* in = argv[q++];
  const char* out = argv[q++];
  std::vector<long long> ns(atoi(argv[q++]));
  for (long long& n : ns) n = atoll(argv[q++]);
  std::vector<int> x(cells), y(cells);
  FILE* f = fopen(in, "rb");
  if (fread(x.data(), 4, cells, f) != cells) return 2;
  fclose(f);
  f = fopen(out, "wb");
  for (long long n : ns) {
    int ctas = 0;
    const int status = probe_chain_chunk_cluster(k, w, rows, cols, x.data(),
                                                 y.data(), n, nullptr, &ctas);
    printf("%d %d\n", status, ctas);
    fwrite(y.data(), 4, cells, f);
  }
  fclose(f);
  return 0;
}
'''


def _build(tmp, sources):
  """name -> executable of each of `sources` (name -> text), built at
  once (g++ takes minutes for the narrow source under the sanitizers)."""
  gxx = shutil.which('g++')
  if gxx is None:
    pytest.skip('needs g++')
  procs = {}
  for name, text in sources.items():
    src = tmp / (name + '.cc')
    src.write_text(text)
    procs[name] = subprocess.Popen(
        [gxx] + FLAGS + ['-o', str(tmp / name), str(src)],
        stderr=subprocess.PIPE, text=True)
  for name, proc in procs.items():
    _, err = proc.communicate(timeout=1200)
    assert proc.returncode == 0, err[-4000:]
  return {name: tmp / name for name in sources}


@pytest.fixture(scope='module')
def built(tmp_path_factory):
  """(directory, executables): each kernel's source with its launch
  (strip, chunk), and the same without its exit barrier (strip_cut,
  chunk_cut)."""
  tmp = tmp_path_factory.mktemp('cluster_emulation')
  sources = {}
  for kernel, (barrier, _) in EXIT_BARRIERS.items():
    text = (strip_source() + STRIP_MAIN if kernel == 'strip' else
            chain_source() + CHUNK_MAIN)
    assert text.count(barrier) == 1, kernel
    sources[kernel] = text
    sources[kernel + '_cut'] = text.replace(barrier, '\n')
  return tmp, _build(tmp, sources)


def _run(exe, args, timeout=600):
  proc = subprocess.run([str(exe)] + [str(a) for a in args],
                        capture_output=True, text=True, timeout=timeout)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return [tuple(map(int, line.split())) for line in proc.stdout.split('\n')
          if line.strip()]


@pytest.fixture
def small_forms(monkeypatch):
  """``narrow.CLUSTER_FORMS`` as the emulation builds strip_cluster."""
  monkeypatch.setattr(narrow, 'CLUSTER_FORMS',
                      {'MinI32': (STRIP_ROWS, STRIP_WORDS)})


def strip_run(built, body, x, iters, form=None, phases=None):
  """(outputs at each of `iters`, [(status, grid)]) of `body`'s launch on
  the CPU tensor x (form None: the kernel ``narrow.launch`` picks,
  ``CLUSTER_FORM`` where ``body.cluster``, else the strip kernel, 3;
  `phases`: flat plan arguments in place of the body's)."""
  tmp, exes = built
  if form is None:
    form = narrow.CLUSTER_FORM if body.cluster else narrow.FORMS.index(
        'strip')
  flat = (narrow.launch_geometry(body)[0] if phases is None else phases)
  rows, cols = body.shape
  src, out = tmp / ('%s.in' % id(x)), tmp / ('%s.out' % id(x))
  x.numpy().tofile(src)
  lines = _run(exes['strip'], [form, strip_ops().index(body.op), rows, cols,
                               body.dtype.itemsize, src, out, len(flat),
                               *flat, len(iters), *iters])
  got = np.fromfile(out, x.numpy().dtype).reshape((len(iters),) + body.shape)
  return [torch.from_numpy(g.copy()) for g in got], lines


def strip_ops():
  """The strip ops in the source's order (its STRIP_OPS)."""
  text = (CSRC / narrow.SOURCE).read_text()
  block = text[text.index('#define STRIP_OPS(X)'):]
  return re.findall(r'X\((\w+)\)', block[:block.index('\n\n')])


def small(body, shape):
  return dataclasses.replace(body, shape=shape, kshape=None)


def inputs(body, seed):
  rng = np.random.default_rng(seed)
  if body.dtype == torch.int16:
    return torch.from_numpy(rng.integers(-2**15, 2**15, body.shape,
                                         dtype=np.int16))
  return torch.from_numpy(rng.integers(-2**31, 2**31, body.shape,
                                       dtype=np.int32))


def test_cluster_forms_match_the_source():
  """strip_cluster is built for MinI32 alone, at the blocks
  ``narrow.CLUSTER_FORMS`` names, with the source's furthest tap; of
  every strip body only indep10 runs it, and it differs from the strip
  kernel's grid barrier a phase by one cluster barrier."""
  text = (CSRC / narrow.SOURCE).read_text()
  assert ('#define SODA_CLUSTER_FORMS(X) %s\n' % ' '.join(
      'X(%d, %d)' % form for form in narrow.CLUSTER_FORMS.values()) in text)
  assert list(narrow.CLUSTER_FORMS) == ['MinI32'] and 'MinI32' in strip_ops()
  assert 'std::is_same<B, MinI32>::value' in text
  assert ('constexpr int kMaxDist = %d;' % narrow.CLUSTER_MAX_DIST) in text
  bodies = [b for b in (list(narrow.BODIES.values()) +
                        list(narrow.EXP24_SHIFT.values())) if b.cluster]
  assert bodies == [_INDEP10]
  assert _INDEP10.barriers == (0, 1) and _INDEP10.old_barriers == (1, 0)


@pytest.mark.parametrize('name,body,shape', STRIP_CASES,
                         ids=[c[0] for c in STRIP_CASES])
def test_strip_cluster_matches_plain_and_old_form(built, small_forms, name,
                                                 body, shape):
  """Each body of independent phases on strip_cluster (one cluster of 1
  to 16 CTAs), bit for bit against its plain version and the strip
  kernel's grid-barrier form."""
  body = small(body, shape)
  assert body.cluster, name
  x = inputs(body, 5)
  iters = probes.CHECK_ITERS
  got, lines = strip_run(built, body, x, iters)
  old, old_lines = strip_run(built, body, x, iters, form=3)
  assert lines == [(0, shape[0] // STRIP_ROWS)] * len(iters), lines
  assert all(status == 0 for status, _ in old_lines)
  for n, g, o in zip(iters, got, old):
    want = body.plain(x, n=n)
    assert torch.equal(g, want), (name, n)
    assert torch.equal(o, want), (name, n)


_LANES = (1, (1, 2, 4, 8, 3), (1, 2, 4, 8, 3))  # indep10's phase
# (why, op, shape, phases): plans strip_cluster does not take; the strip
# kernel runs each
REFUSED = (
    ('a tap 9 on', 'MinI32', (128, 64), ((1, (9, 1), (1,)),)),
    ('a cross tap 9 on', 'MinI32', (128, 64), ((1, (1,), (9,)),)),
    ('an independent phase along the sublanes', 'MinI32', (128, 64),
     ((0, (1, 2), (1,)),)),
    ('a chained phase', 'MinI32', (128, 64), (_LANES, (0, (1, 2)))),
    ('chained phases alone (roll10)', 'MinI32', (128, 64),
     narrow.EXP24_SHIFT['roll10'].phases),
    ('an op it is not built for', 'MinI16', (128, 128), (_LANES,)),
    ('rows of no whole bands', 'MinI32', (8, 64), (_LANES,)),
    ('more than 16 bands', 'MinI32', (512, 64), (_LANES,)),
    ('another width', 'MinI32', (128, 32), (_LANES,)),
)


@pytest.mark.parametrize('why,op,shape,phases', REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_strip_cluster_refuses_what_the_plan_rule_sends_elsewhere(
    built, small_forms, why, op, shape, phases):
  """A plan strip_cluster does not take is refused at launch (form 6;
  nothing falls back), and ``NarrowBody.cluster`` (the plan rule
  ``narrow.launch`` follows) sends it to the strip kernel, which runs it
  bit for bit."""
  body = dataclasses.replace(
      _INDEP10, op=op, shape=shape, kshape=None, phases=phases,
      dtype=torch.int16 if op == 'MinI16' else torch.int32)
  assert not body.cluster, why
  x = inputs(body, 1)
  _, lines = strip_run(built, body, x, (2,), form=narrow.CLUSTER_FORM)
  assert lines[0][0] != 0, why
  got, lines = strip_run(built, body, x, (2,))
  assert lines[0][0] == 0, why
  assert torch.equal(got[0], body.plain(x, n=2)), why


def chunk_run(built, k_rows, lane_tile, x, iters):
  tmp, exes = built
  src, out = tmp / 'chunk.in', tmp / 'chunk.out'
  x.numpy().tofile(src)
  lines = _run(exes['chunk'], [k_rows, lane_tile, *x.shape, src, out,
                               len(iters), *iters])
  got = np.fromfile(out, np.int32).reshape((len(iters),) + tuple(x.shape))
  return [torch.from_numpy(g.copy()) for g in got], lines


@pytest.mark.parametrize('k_rows,lane_tile,shape', CHUNK_CASES,
                         ids=['%dx%d' % c[:2] for c in CHUNK_CASES])
def test_chunk_cluster_matches_plain(built, k_rows, lane_tile, shape):
  """exp24's chunked body on chain_chunk_cluster (its bands of half a
  chunk and its tiles one cluster of 8 or 16 CTAs), bit for bit against
  the script's chunk-by-chunk plain version."""
  x = torch.from_numpy(np.random.default_rng(9).integers(
      -2**31, 2**31, shape, dtype=np.int32))
  got, lines = chunk_run(built, k_rows, lane_tile, x, probes.CHECK_ITERS)
  ctas = (shape[0] // (k_rows // 2)) * (shape[1] // lane_tile)  # bands
  assert lines == [(0, ctas)] * len(probes.CHECK_ITERS)
  step = probes._chunk_step(k_rows, lane_tile)
  want = x
  for n in range(1, max(probes.CHECK_ITERS) + 1):
    want = step(want)
    if n in probes.CHECK_ITERS:
      assert torch.equal(got[probes.CHECK_ITERS.index(n)], want), n


def test_chunk_cluster_refuses_what_it_does_not_take(built):
  """Rows or lanes of no whole chunks (whole bands or not), a form it
  is not built for, more than 16 bands: refused at launch."""
  for k, w, shape in ((32, 64, (120, 128)), (32, 64, (128, 96)),
                      (24, 32, (36, 32)), (32, 128, (128, 128)),
                      (32, 64, (640, 128))):
    x = torch.zeros(shape, dtype=torch.int32)
    _, lines = chunk_run(built, k, w, x, (1,))
    assert lines[0][0] != 0, (k, w, shape)


@pytest.mark.parametrize('kernel', sorted(EXIT_BARRIERS))
def test_kernel_without_its_exit_barrier_aborts(built, kernel):
  """With its last cluster wait removed, a CTA may leave while another
  still reads its shared memory: the emulation aborts; with it, the same
  launch runs."""
  tmp, exes = built
  src, out = tmp / ('%s_exit.in' % kernel), tmp / ('%s_exit.out' % kernel)
  np.arange(64 * 256, dtype=np.int32).tofile(src)
  args = [str(a).format(**{'in': src, 'out': out})
          for a in EXIT_BARRIERS[kernel][1]]
  _run(exes[kernel], args)
  proc = subprocess.run([str(exes[kernel + '_cut'])] + args,
                        capture_output=True, text=True, timeout=600)
  assert proc.returncode != 0
  assert 'read after that CTA passed its last barrier' in proc.stderr


# sha256 (first 16 hex digits) of the old chunk kernel (its section, from
# its header to the next) and its launchers, as the parent had them
PARENT_CHAIN_SECTIONS = {
    '// -- form 1: chunked chains in shared memory': '17059daf222dd411',
}
PARENT_CHAIN_DEFINITIONS = {
    'cudaError_t co_resident(': '3085092800cec2a1',
    'cudaError_t cooperative(': '00667ed036994e0d',
    'template <int K, int W>\ncudaError_t launch_chunk(': '98283ee15bcfbc64',
}


def _digest(text):
  return hashlib.sha256(text.encode()).hexdigest()[:16]


@pytest.mark.parametrize('header', sorted(PARENT_CHAIN_SECTIONS))
def test_old_chunk_kernel_is_unchanged(header):
  text = (CSRC / 'probe_chain.cu').read_text()
  assert text.count(header) == 1
  start = text.index(header)
  end = text.index('\n// -- ', start + 1) + 1
  assert _digest(text[start:end]) == PARENT_CHAIN_SECTIONS[header]


@pytest.mark.parametrize('head', sorted(PARENT_CHAIN_DEFINITIONS))
def test_old_chunk_launchers_are_unchanged(head):
  text = (CSRC / 'probe_chain.cu').read_text()
  assert text.count(head) == 1
  start = text.index(head)
  end = text.index('\n}\n', start) + 3
  assert _digest(text[start:end]) == PARENT_CHAIN_DEFINITIONS[head]


def test_public_forms_launch_the_cluster_kernels():
  """Form 1 of probe_chain_launch is chain_chunk_cluster and form 3 the
  old chain_chunk; form 6 of probe_narrow_launch is strip_cluster and
  form 3 the strip kernel, as it was."""
  chain = (CSRC / 'probe_chain.cu').read_text()
  launch = chain[chain.index('int probe_chain_launch('):]
  assert launch.index('probe_chain_chunk_cluster(') < launch.index(
      'launch_chunk<32, 1024>')
  assert probes.OLD_CHUNK_FORM == 3 and probes.FORMS['chunk'] == 1
  text = (CSRC / narrow.SOURCE).read_text()
  launch = text[text.index('int probe_narrow_launch('):]
  assert ('if (form == 6)\n      return static_cast<int>(\n          '
          'kStripCluster[op] ? kStripCluster[op](' in launch)
  assert ('return static_cast<int>(kStrip[op](a, y, tmp, plan, n, s, ctas));'
          in launch)
  assert narrow.CLUSTER_FORM == 6 and 'strip' not in narrow.OLD_FORMS
