"""Traffic drivers, one module a kind of traffic. A traffic mix is a data
file ``portbench/traffic/<name>.json`` that names its driver and gives its
parameters; the driver issues the calls a user of that kind makes.

Each driver has ``setup(ctx, params) -> state``, ``warm(ctx, state)``
(every shape the window uses, once), ``call(ctx, state, i)`` (call ``i``
of the window; a call that must end in a synchronise does so itself) and
``units(params)``: samples per pixel or frames a call completes.
"""
