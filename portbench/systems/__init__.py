"""How the program is deployed and driven, one module a kind of
configuration: ``build(config, mix, seed, device, reference)`` returns the
system under test, with ``call(i)`` (batch ``i`` through the executor),
``sync()``, ``probes()``, ``release()`` and ``check(kept, check)``."""
