"""python -m vulkan_pathtracer_tpu — headless render driver."""

from vulkan_pathtracer_tpu.app.main import main

raise SystemExit(main())
