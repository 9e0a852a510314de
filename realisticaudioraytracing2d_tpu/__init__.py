"""2D realistic-audio ray tracing framework on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``clarkipeng/RealisticAudioRaytracing2D`` (a Unity C#/HLSL GPU audio ray
tracer): stochastic 2D acoustic path tracing against polygon scenes with
per-material absorption/scattering/transmission/refraction, impulse-response
construction via scatter-add, Monte-Carlo accumulation across
frames, and dry-signal convolution — offline bake or real-time chunked
streaming with crossfaded double-buffered IRs — plus multi-source mixdown
and room-dataset sweeps sharded over device meshes.

Quick start::

    import jax
    import realisticaudioraytracing2d_tpu as art
    room = art.rooms.smoll_room()
    eng = art.Engine(room.scene, art.smoll_room_config())
    params = eng.params(room.source, room.listener)
    ir_state = eng.trace_frames(params, jax.random.PRNGKey(0), n_frames=8)
    wet = eng.bake(dry_audio, ir_state)
"""

from . import analysis, config, diff, parallel, spatial, utils
from .config import (AudioConfig, DebugConfig, EngineConfig, SimConfig,
                     big_room_config, sample_scene_config,
                     smoll_room_config)
from .engine import Engine, bake_audio, trace_accumulate
from .models import materials, rooms, scene
from .models.materials import (MATERIAL_ANECHOIC, MATERIAL_BORDER,
                               MATERIAL_INTERIOR, AudioMaterial)
from .models.scene import Scene, SceneBuilder, Transform2D
from .ops import convolve, geometry, ir, trace
from .ops.ir import IRState
from .ops.trace import DebugPaths, Hits, TraceParams
from .streaming import RingBuffer, Streamer, StreamState, stream_chunk

__version__ = "0.1.0"

__all__ = [
    "AudioConfig", "AudioMaterial", "DebugConfig", "DebugPaths", "Engine",
    "EngineConfig", "Hits", "IRState", "MATERIAL_ANECHOIC",
    "MATERIAL_BORDER", "MATERIAL_INTERIOR", "RingBuffer", "Scene",
    "SceneBuilder", "SimConfig", "StreamState", "Streamer", "TraceParams",
    "Transform2D", "bake_audio", "big_room_config", "config", "convolve",
    "diff", "geometry", "ir", "materials", "parallel", "rooms",
    "sample_scene_config",
    "analysis", "scene", "smoll_room_config", "stream_chunk", "trace",
    "trace_accumulate",
    "utils",
]
