"""Adapters that hand frames to one public entry of the program, found by
the ``entry`` of a traffic file (``entries/<entry>.py``).

Each module defines ``Entry(ctx)`` with

- ``kind``: the reference step that checks it, ``"handler"`` or ``"step"``;
- ``seed(imgs, R_wc, t_wc, depths)``: each stream's frame 0 from its
  ground-truth depth (set-up);
- ``warm(n_done, keyframes)``: whether set-up has run every shape the
  window will (no capture after it), ``keyframes`` being the fewest that
  any stream has inserted;
- ``step(imgs) -> Result``: one frame per stream handed to the entry, its
  result on the host;
- ``keep()``: the state the next step starts from, kept as cheaply as
  the entry allows (the window keeps it before every step, since a step
  is known to be a keyframe only once it has run);
- ``release(kept)``: a kept state that the check does not need;
- ``hold(kept, streams) -> {b: held}``: what the check keeps of a kept
  state for each of the given streams;
- ``leaves(held)``, ``fields(held)`` and ``map_of(held)``: one stream's
  held state as the reference takes it, and its map.
"""
