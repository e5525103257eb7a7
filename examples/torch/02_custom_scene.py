"""Build a scene from scratch: materials, textures, spheres (the port's
counterpart of examples/02_custom_scene.py).

    python examples/torch/02_custom_scene.py [--device cpu]
"""

import numpy as np

from _common import parse_args


def main():
    args = parse_args("render a hand-built scene",
                      **{"--out": dict(default="example_custom.png")})
    from weekend_raytracer_tpu_torch import RenderParams, Renderer, SamplingParams
    from weekend_raytracer_tpu_torch.models.camera import Camera
    from weekend_raytracer_tpu_torch.models.materials import Material
    from weekend_raytracer_tpu_torch.models.scenes import SceneDesc
    from weekend_raytracer_tpu_torch.models.sky import SkyParams
    from weekend_raytracer_tpu_torch.models.spheres import Sphere
    from weekend_raytracer_tpu_torch.models.textures import Texture
    from weekend_raytracer_tpu_torch.utils.image import save_png

    # A procedural image texture from any float RGB array (or use
    # Texture.from_image("photo.jpeg") for files).
    stripes = np.zeros((64, 128, 3), np.float32)
    stripes[:, ::8] = (0.9, 0.3, 0.1)
    stripes[:, 1::8] = (0.95, 0.85, 0.6)

    materials = [
        Material.checkerboard((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)),  # ground
        Material.lambertian(Texture.from_array(stripes)),
        Material.metal((0.8, 0.85, 0.88), fuzz=0.05),
        Material.dielectric(1.5),
        Material.emissive((1.0, 0.9, 0.7), intensity=4.0),  # beyond-reference
    ]
    spheres = [
        Sphere((0.0, -500.0, 0.0), 500.0, material_idx=0),
        Sphere((-2.2, 1.0, 0.0), 1.0, material_idx=1),
        Sphere((0.0, 1.0, 0.0), 1.0, material_idx=2),
        Sphere((2.2, 1.0, 0.0), 1.0, material_idx=3),
        Sphere((2.2, 1.0, 0.0), -0.9, material_idx=3),  # hollow glass shell
        Sphere((0.0, 4.5, -2.0), 1.2, material_idx=4),  # area light
    ]
    scene = SceneDesc(materials=materials, spheres=spheres)

    params = RenderParams(
        camera=Camera.look_at(eye=(0.0, 2.0, 8.0), target=(0.0, 1.0, 0.0),
                              vfov_degrees=35.0, aperture=0.05,
                              focus_distance=8.0),
        viewport_size=(400, 300),
        sampling=SamplingParams(max_samples_per_pixel=16,
                                num_samples_per_pixel=2, num_bounces=8),
        sky=SkyParams(azimuth_degrees=200.0, zenith_degrees=40.0,
                      turbidity=3.0),
    )
    r = Renderer(scene, params, device=args.device)
    r.render()
    save_png(args.out, r.image())
    print(f"custom scene ({scene.num_spheres} spheres) backend={r.backend} "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
