# Mirrors the reference's Makefile targets (Makefile:5-10) without mpiexec:
# device parallelism comes from the JAX mesh.

PY ?= python

all: native

native:
	$(MAKE) -C native

test:
	$(PY) -m fem_tpu -f examples/cohesive_interface.inp

test-lin:
	$(PY) -m fem_tpu -f examples/ref/lin_two_quads_qs.inp

test-elastic:
	$(PY) -m fem_tpu -f examples/ref/SNES_test/elastic/elastic_test.inp

test-generated: examples/generated_example.inp
	$(PY) -m fem_tpu -f examples/generated_example.inp

examples/generated_example.inp:
	$(PY) -c "from fem_tpu.io import meshgen; open('examples/generated_example.inp','w').write(meshgen.quad_strip_deck(10, 1))"

unit:
	$(PY) -m pytest tests/ -q -m "not slow"

unit-slow:
	$(PY) -m pytest tests/ -q -m slow

unit-all:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

clean:
	$(MAKE) -C native clean
	rm -f *_output_*.vtk examples/generated_example.inp

.PHONY: all native test test-lin test-elastic test-generated unit unit-slow unit-all bench smoke clean
