"""The loops that drive the program, one module per entry.

A traffic mix names its ``entry``; the harness imports
``portbench.entries.<entry>`` and builds its ``Cell(cfg, mix, seed,
device, spans, devices=devices, control=False)``.  ``devices`` are the
cell's ``chips`` cards in order (``cuda:0`` ..; on the CPU, ``chips``
times ``cpu``) and ``device`` is ``devices[0]``: a loop on one card uses
``device`` alone, a loop across cards puts its blocks on ``devices``.
The harness synchronises and measures every card of ``devices``.  A new
loop is a new module here; no file that exists needs an edit.  A
``Cell`` has:

* ``n``, ``graph`` (``deploy.make_graph``'s result) and ``b`` (the error
  budget);
* ``warm()``: one unit of the cell's own shapes from a warm-up stream,
  counted in ``setup_s``;
* ``unit()``: one unit of the window's work, appended to ``units``;
* ``walks()``: walks probed in the window; ``attempted()`` and ``failed``:
  answers due and answers that failed;
* ``facts()``: sizes the per-layer readers need, taken before the window;
  ``counters()``: the program's counters (a reader takes their change
  over the window);
* ``free()``: drops the program's state once the window has closed;
* ``compared(seed)``: the numbers ``correct`` compares, worked out by the
  plain reference over the units that the seed picks, after ``free()``;
  returns ``(numbers, missing)``.

With ``control=True`` the cell puts its control in the program's place:
the nearest precision below the configuration's.
"""
