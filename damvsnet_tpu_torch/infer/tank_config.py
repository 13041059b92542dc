"""Per-scene Tanks-and-Temples fusion confidences (a copy of
damvsnet_tpu/infer/tank_config.py).

Values as the reference's filter/tank_test_config.py:10-78 sets them (yacs
CfgNode replaced by a plain attribute-dict — no external dependency).
"""
from __future__ import annotations


class SceneCfg(dict):
    __getattr__ = dict.__getitem__


def _scene(conf, max_h=1080, max_w=2048):
    return SceneCfg(conf=conf, max_h=max_h, max_w=max_w)


TANK_CFG = SceneCfg(
    META_ARC="tank_test_config",
    scenes=(
        "Family", "Francis", "Horse", "Lighthouse", "M60", "Panther",
        "Playground", "Train", "Auditorium", "Ballroom", "Courtroom",
        "Museum", "Palace", "Temple",
    ),
    # intermediate
    Family=_scene([0.4, 0.6, 0.85]),
    Francis=_scene([0.4, 0.6, 0.9]),
    Horse=_scene([0.1, 0.15, 0.65]),
    Lighthouse=_scene([0.5, 0.6, 0.9]),
    M60=_scene([0.4, 0.7, 0.8]),
    Panther=_scene([0.1, 0.15, 0.8]),
    Playground=_scene([0.4, 0.6, 0.9]),
    Train=_scene([0.3, 0.6, 0.9]),
    # advanced
    Auditorium=_scene([0.0, 0.0, 0.4]),
    Ballroom=_scene([0.0, 0.0, 0.5]),
    Courtroom=_scene([0.0, 0.0, 0.4]),
    Museum=_scene([0.0, 0.0, 0.7]),
    Palace=_scene([0.0, 0.0, 0.7]),
    Temple=_scene([0.0, 0.0, 0.4]),
)
