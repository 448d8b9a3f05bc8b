"""Scene generators, one module a scene, found by the name a configuration
gives under ``scene``. Each ``build(params, seed, workdir)`` returns plain
numpy arrays and imports nothing of the program."""
