"""Round-2 feature demo renders -> artifacts/ (sky, toon, velvet,
adaptive subdivision, particles). Run from the repo root."""

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathlib import Path

import numpy as np


def main():
    import jax
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    from raytracingproject_tpu.app import examples
    from raytracingproject_tpu.models import (Scene, Object, Light,
                                              Shader, ShaderGraph,
                                              shader_nodes as sn)
    from raytracingproject_tpu.models.mesh import (make_sphere_mesh,
                                                   make_plane_mesh, Mesh)
    from raytracingproject_tpu.session import Session, SessionParams
    from raytracingproject_tpu.utils import image_io
    from raytracingproject_tpu.utils import transform as tfm
    out = Path("artifacts")
    out.mkdir(exist_ok=True)

    def render(scene, name, spp=48):
        sess = Session(scene, SessionParams(samples=spp))
        sess.reset()
        sess.render()
        sess.write_output(str(out / name))
        print(name, "done", flush=True)

    # --- nishita sky over a ground plane with spheres ---
    scene = Scene()
    scene.camera.set("matrix", tfm.look_at((0, -14, 2.0), (0, 0, 2.2),
                                           (0, 0, 1)))
    scene.camera.set("fov", 0.7)
    scene.camera.set("width", 320)
    scene.camera.set("height", 200)
    g = ShaderGraph()
    sky = g.add(sn.SkyTextureNode(
        "sky", sky_type="nishita",
        sun_elevation=float(np.radians(8.0)),
        sun_rotation=float(np.radians(35.0)), dust_density=2.0))
    bg = g.add(sn.BackgroundNode("bg", strength=1.0))
    g.connect(sky, "color", bg, "color")
    g.connect(bg, "background", g.output_node, "surface")
    scene.background.shader = Shader("sky_bg", g)
    scene.add_light(Light("bg", light_type="background"))
    ground = make_plane_mesh((-40, -40, 0), (80, 0, 0), (0, 80, 0))
    ground.used_shaders = [examples.diffuse_shader("gnd", (0.4, 0.38, 0.35))]
    scene.add_shader(ground.used_shaders[0])
    scene.add_object(Object("ground", ground))
    mirror = examples.glossy_shader("chrome", (0.9, 0.9, 0.9), 0.08)
    scene.add_shader(mirror)
    s1 = make_sphere_mesh((-2.5, 0, 2.0), 2.0, 0, nlat=24, nlon=48)
    s1.set("smooth", np.ones(s1.num_triangles, bool))
    s1.used_shaders = [mirror]
    scene.add_object(Object("chrome", s1))
    white = examples.diffuse_shader("wht", (0.75, 0.75, 0.75))
    scene.add_shader(white)
    s2 = make_sphere_mesh((2.5, 1.5, 1.5), 1.5, 0, nlat=24, nlon=48)
    s2.set("smooth", np.ones(s2.num_triangles, bool))
    s2.used_shaders = [white]
    scene.add_object(Object("ball", s2))
    scene.integrator.set("max_bounce", 4)
    render(scene, "nishita_sunset.png", spp=48)

    # --- toon + velvet spheres in the furnace-style light ---
    scene = Scene()
    scene.camera.set("matrix", tfm.look_at((0, -9, 1.2), (0, 0, 1.0),
                                           (0, 0, 1)))
    scene.camera.set("fov", 0.55)
    scene.camera.set("width", 320)
    scene.camera.set("height", 180)
    bgs = examples.background_shader("bg", (0.5, 0.6, 0.75), 1.0)
    scene.background.shader = bgs
    scene.add_light(Light("bg", light_type="background"))
    lamp = Light("key", light_type="area", strength=(500, 480, 450))
    lamp.set("co", (4, -6, 6))
    lamp.set("sizeu", 1.5)
    lamp.set("sizev", 1.5)
    scene.add_light(lamp)
    floor = make_plane_mesh((-12, -12, 0), (24, 0, 0), (0, 24, 0))
    floor.used_shaders = [examples.diffuse_shader("floor", (0.5,) * 3)]
    scene.add_shader(floor.used_shaders[0])
    scene.add_object(Object("floor", floor))
    mats = [examples.toon_shader("toon_d", (0.85, 0.25, 0.2),
                                 component="diffuse", size=0.7,
                                 smooth=0.05),
            examples.toon_shader("toon_g", (0.2, 0.5, 0.9),
                                 component="glossy", size=0.25,
                                 smooth=0.1),
            examples.velvet_shader("velvet", (0.6, 0.1, 0.45),
                                   sigma=0.8)]
    for i, m in enumerate(mats):
        scene.add_shader(m)
        s = make_sphere_mesh((-3.0 + 3.0 * i, 0, 1.0), 1.2, 0,
                             nlat=24, nlon=48)
        s.set("smooth", np.ones(s.num_triangles, bool))
        s.used_shaders = [m]
        scene.add_object(Object(f"s{i}", s))
    scene.integrator.set("max_bounce", 3)
    render(scene, "toon_velvet.png", spp=64)

    # --- adaptive subdivision + displacement ---
    scene = Scene()
    scene.camera.set("matrix", tfm.look_at((0, -6, 2.4), (0, 0, 0.3),
                                           (0, 0, 1)))
    scene.camera.set("fov", 0.6)
    scene.camera.set("width", 320)
    scene.camera.set("height", 200)
    scene.background.shader = examples.background_shader(
        "bg", (0.7, 0.75, 0.85), 1.0)
    scene.add_light(Light("bg", light_type="background"))
    g = ShaderGraph()
    wave = g.add(sn.WaveTextureNode("w", scale=2.5, distortion=1.5))
    disp = g.add(sn.DisplacementNode("d", scale=0.35, midlevel=0.5))
    dif = g.add(sn.DiffuseBsdfNode("df", color=(0.75, 0.65, 0.5)))
    g.connect(wave, "fac", disp, "height")
    g.connect(dif, "bsdf", g.output_node, "surface")
    g.connect(disp, "displacement", g.output_node, "displacement")
    mat = Shader("dispmat", g)
    scene.add_shader(mat)
    m = Mesh("plane")
    m.set_mesh(np.array([[-3, -3, 0], [3, -3, 0], [3, 3, 0],
                         [-3, 3, 0]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    m.set("subdivision_type", "linear")
    m.set("max_subdivisions", 7)
    m.set("dicing_rate", 4.0)
    m.used_shaders = [mat]
    scene.add_object(Object("plane", m))
    scene.integrator.set("max_bounce", 3)
    render(scene, "subdivision_displaced.png", spp=48)

    print("round-2 demos complete")


if __name__ == "__main__":
    main()
