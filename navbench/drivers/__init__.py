"""The drivers: each builds the system under test for a traffic mix's
``driver``, runs its timed steps, and checks them against the reference.

A driver module holds ``Driver(config, traffic, seed, device)`` with
``step()`` (one timed step), ``tally()`` (cumulative counts),
``outcome()`` ((attempted, failed)), ``metrics(window_s)`` (end-to-end
values), ``trace_info()`` (the shapes the per-layer readers need),
``release()`` (frees the program's state), ``readings(dtype)`` (the
numbers compared with the reference: the program's, or with a lower
``dtype`` the control's) and ``limits`` (the traffic file's limits).
"""
