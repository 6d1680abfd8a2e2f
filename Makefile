PY := PYTHONPATH=src$(if $(PYTHONPATH),:$(PYTHONPATH)) python
STAMP := $(shell date -u +%Y%m%dT%H%M%SZ)
SMOKE_DUMPS := BENCH_prefix_cache.json BENCH_online.json \
    BENCH_replicas.json BENCH_radix.json

.PHONY: test test-fast lint analyze check serve-online bench-online \
    bench-smoke bench-compare bench-trend serve-online-torch examples-torch

# default pre-commit check: repo-wide lint + invariant analyzer +
# sub-minute smoke subset
check: lint analyze test-fast

lint:
	python tools/lint.py

# repo-specific invariant analyzer (lock discipline/order, blocking
# calls under locks, connector key lifetime, spawn safety, deprecated
# surfaces).  Exits non-zero on any non-baselined finding; see
# tools/analyze/__init__.py for the rule codes and the noqa/baseline
# workflow.  `make analyze JSON=findings.json` also dumps JSON.
analyze:
	python -m tools.analyze $(if $(JSON),--json $(JSON))

test-fast:
	$(PY) -m pytest -q -m fast

# full tier-1 suite (~6.5 min)
test:
	$(PY) -m pytest -q

# online serving demo through the per-stage-worker backend
serve-online:
	$(PY) -m repro.launch.serve --pipeline qwen_omni --online \
	    --requests 12 --rate 4.0 --max-inflight 8

# the same on the PyTorch port (on the card; DEVICE=cpu for the CPU)
DEVICE ?= cuda
serve-online-torch:
	$(PY) -m repro_torch.launch.serve --pipeline qwen_omni --online \
	    --requests 12 --rate 4.0 --max-inflight 8 --device $(DEVICE)

# the port's five examples (examples/*_torch.py)
examples-torch:
	$(PY) examples/quickstart_torch.py --device $(DEVICE)
	$(PY) examples/image_generation_torch.py --device $(DEVICE)
	$(PY) examples/omni_serving_torch.py --device $(DEVICE)
	$(PY) examples/process_isolation_torch.py --device $(DEVICE)
	$(PY) examples/train_tiny_torch.py --device $(DEVICE)

# concurrent-stage vs lock-step comparison with a slowed stage
bench-online:
	$(PY) -m benchmarks.bench_online

# sub-minute benchmark smoke: online serving + prefix caching (flat and
# radix) + replica scaling.  Each dump is archived under
# benchmarks/history/ with a UTC timestamp so benchmarks/compare.py
# --archive can render the cross-PR trend.
bench-smoke:
	$(PY) -m benchmarks.bench_prefix_cache --smoke \
	    --json BENCH_prefix_cache.json
	$(PY) -m benchmarks.bench_online --smoke --json BENCH_online.json
	$(PY) -m benchmarks.bench_replicas --smoke --json BENCH_replicas.json
	$(PY) -m benchmarks.bench_radix --smoke --json BENCH_radix.json
	mkdir -p benchmarks/history
	for f in $(SMOKE_DUMPS); do \
	    cp $$f benchmarks/history/$(STAMP)_$$f; done
	$(PY) -m benchmarks.compare $(SMOKE_DUMPS) || true
	$(PY) -m benchmarks.compare --archive || true

# diff two or more BENCH_*.json dumps (regression table / trend):
#   make bench-compare FILES="old.json new.json"
bench-compare:
	$(PY) -m benchmarks.compare $(FILES)

# cross-run trend from everything archived under benchmarks/history/
bench-trend:
	$(PY) -m benchmarks.compare --archive
