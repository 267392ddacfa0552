"""Parse robot FK pose files into arrays of 4x4 homogeneous matrices.

The on-disk format (produced by the robot controller) is a sequence of
bracket-and-semicolon matrices::

    [  r00, r01, r02, tx ;
       r10, r11, r12, ty ;
       r20, r21, r22, tz ;
       0, 0, 0, 1 ];

Tolerant of blank lines, irregular whitespace, and scientific notation.
Reference semantics: parser_instant_ngp.py:20-46.

Counterpart of ``nerf_kinematics_tpu/poses/parser.py`` (numpy: the same
regular expressions and the same rows-of-four rule).
"""

from __future__ import annotations

import re

import numpy as np

# A single floating-point token, incl. scientific notation ("1e-3", "-53.612386").
_NUM_RE = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")
# Everything between one [ ... ] pair, across newlines.
_MAT_RE = re.compile(r"\[\s*(.*?)\s*\]", re.DOTALL)


def parse_poses_text(text: str) -> np.ndarray:
    """Parse pose-file text into an (N, 4, 4) float64 array.

    Rows inside a matrix are separated by ';'; rows that do not contain exactly
    four numeric tokens are skipped; only blocks yielding exactly four valid rows
    become matrices.
    """
    mats = []
    for block in _MAT_RE.findall(text):
        rows = []
        for row in block.split(";"):
            nums = _NUM_RE.findall(row)
            if len(nums) == 4:
                rows.append([float(t) for t in nums])
        if len(rows) == 4:
            mats.append(rows)
    if not mats:
        raise ValueError("no 4x4 pose matrices found in poses text")
    return np.asarray(mats, dtype=np.float64)


def parse_poses_file(path) -> np.ndarray:
    """Parse a poses.txt file into an (N, 4, 4) float64 array."""
    with open(path, "r") as f:
        return parse_poses_text(f.read())
