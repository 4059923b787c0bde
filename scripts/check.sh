#!/usr/bin/env bash
# CI gate (the reference's build+ctest matrix and pip import-smoke,
# .github/workflows/linux.yaml:42-58 and build-pip.yml:66-73, adapted to a
# pure-Python + on-demand-native package): syntax gate, full test suite,
# wheel build, import-only smoke test of the *installed* wheel.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== syntax gate =="
python -m compileall -q kaldi_decoder_tpu tests scripts bench.py chip_smoke.py __graft_entry__.py

echo "== style gate =="
python scripts/check_style.py

echo "== native build =="
python - <<'PY'
from kaldi_decoder_tpu import native
ok = native.available()
print("native lib:", "built+loaded" if ok else "unavailable (pure-Python fallbacks active)")
PY

echo "== test suite =="
python -m pytest tests/ -q

echo "== wheel build =="
rm -rf build dist *.egg-info
python -m build --wheel --no-isolation -o dist >/dev/null
WHEEL=$(ls dist/*.whl)
echo "built $WHEEL"

echo "== wheel import smoke =="
SMOKE=$(mktemp -d)
python -m pip install -q --target "$SMOKE" --no-deps --no-index "$WHEEL"
(cd "$SMOKE" && PYTHONPATH="$SMOKE" python -c "
import kaldi_decoder_tpu
print('import ok:', kaldi_decoder_tpu.__name__)
names = ['DecodableCtc','DecodableInterface','FasterDecoder','FasterDecoderOptions',
         'LatticeSimpleDecoder','LatticeSimpleDecoderConfig','SimpleDecoder']
missing = [n for n in names if not hasattr(kaldi_decoder_tpu, n)]
assert not missing, missing
print('reference API surface present:', len(names), 'names')
")
rm -rf "$SMOKE"
echo "== check PASSED =="
