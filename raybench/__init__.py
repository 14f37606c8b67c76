"""raybench: the benchmark of the PyTorch and CUDA port
(``gpgpuraytrace_tpu_torch``) on NVIDIA H100 cards.

Run one cell: ``python3 -m raybench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the repository's root
lists the cells and metrics; the harness finds each by name:

* a cell: its ``workloads`` entry (configuration, traffic, chips) and
  ``limits/<cell>.json`` (the limit of each number compared);
* a configuration: ``configs/<config>.json`` (the render settings and the
  scene, its source and what was cut);
* a traffic mix: ``traffic/<traffic>.json`` (its parameters), run by the
  driver ``drivers/<entry>.py`` that its ``entry`` names (it drives one
  entry of the port for the window and checks what that produced against
  the reference);
* a per-layer metric: ``metrics/<metric>.py`` (reads the traced run; the
  shared reductions are in ``readers.py``).

``reference/`` is the plain PyTorch yardstick, ``roofline.py`` the frozen
operation and byte counts with the card's published peaks.
"""
