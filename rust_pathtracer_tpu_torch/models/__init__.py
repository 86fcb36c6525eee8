from rust_pathtracer_tpu_torch.models.scenes import (
    SCENES,
    SceneDef,
    cornell_box_scene,
    get_scene,
    light_test_scene,
    model_test_scene,
    sphere_field_scene,
    triangle_test_scene,
    two_sphere_checkers_scene,
)

__all__ = [
    "SCENES",
    "SceneDef",
    "cornell_box_scene",
    "get_scene",
    "light_test_scene",
    "model_test_scene",
    "sphere_field_scene",
    "triangle_test_scene",
    "two_sphere_checkers_scene",
]
