"""flatten_s: the host's clock around the scene's load into the program's
scene graph and ``scene.flatten.flatten``, ending in a synchronise."""


def read(r):
    return r.flatten_s
