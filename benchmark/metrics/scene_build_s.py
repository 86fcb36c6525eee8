"""scene_build_s: the host clock around the program's scene build
(``SceneDef.build`` on the device, closed by a device sync), part of
set-up."""


def read(ctx):
    return ctx["scene_build_s"]
