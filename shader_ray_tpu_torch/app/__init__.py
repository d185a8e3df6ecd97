"""Application layer: interaction state machine, materials, camera,
benchmark, screenshot and the CLI (counterpart of shader_ray_tpu/app;
the reference's GLFW app, ray.cpp:719-1148), driving the Renderer's frame
functions instead of a GL draw."""
