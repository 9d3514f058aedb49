"""Settings persistence for the port's front ends (reference
vk_gltf_renderer_tpu/utils/settings.py).

The reference persists renderer settings through the ImGui ini handler and
excludes any key the CLI parsed this run (`wasParsed` filter,
renderer.cpp:224-254), plus a recent-files list. The store is a JSON file:

  $VKGR_SETTINGS or ~/.config/vk_gltf_renderer_tpu_torch/settings.json

`apply_saved_settings(args, argv)` overlays saved values onto parsed args
ONLY for options absent from argv — the same precedence: CLI beats saved
settings beats built-in defaults.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

# flags worth remembering across runs (rendering preferences, not
# per-invocation I/O like --scenefile/--output/--frames)
PERSISTED = (
    "renderSystem",
    "envSystem",
    "envIntensity",
    "envRotation",
    "ptSamples",
    "ptDepth",
    "ptFireflyClamp",
    "ptAperture",
    "ptFocalDistance",
    "tonemapper",
    "infinitePlane",
    "infinitePlaneDistance",
    "infinitePlaneShadowCatcher",
)
MAX_RECENT = 10


def settings_path() -> Path:
    env = os.environ.get("VKGR_SETTINGS")
    if env:
        return Path(env)
    return Path.home() / ".config" / "vk_gltf_renderer_tpu_torch" / "settings.json"


def load_settings() -> dict:
    try:
        return json.loads(settings_path().read_text())
    except (OSError, ValueError):
        return {}


def save_settings(data: dict) -> None:
    p = settings_path()
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(data, indent=1, sort_keys=True))
    except OSError:
        pass  # read-only home: persistence is best-effort


def apply_saved_settings(args, argv) -> None:
    """Overlay saved values onto argparse `args` for flags NOT in argv."""
    saved = load_settings().get("flags", {})
    passed = {a.split("=", 1)[0] for a in (argv or []) if a.startswith("--")}
    for key in PERSISTED:
        if key in saved and f"--{key}" not in passed:
            setattr(args, key, saved[key])


def remember(args, scene_path: str | None) -> None:
    """Persist the current flag values + update the recent-files list."""
    data = load_settings()
    data["flags"] = {k: getattr(args, k) for k in PERSISTED if hasattr(args, k)}
    if scene_path:
        recent = [scene_path] + [r for r in data.get("recent_files", []) if r != scene_path]
        data["recent_files"] = recent[:MAX_RECENT]
    save_settings(data)


def recent_files() -> list:
    return load_settings().get("recent_files", [])
