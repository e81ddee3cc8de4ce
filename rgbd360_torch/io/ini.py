"""Minimal INI parser for the matcher config files
(reference config_files/configLocaliser_spherical{,Odometry}.ini).

The files use //-comments, %-comments and stray prose lines; the reference
reads them through MRPT's CConfigFile. This parser keeps key=value pairs per
[section] and ignores everything else. A copy of rgbd360_tpu/io/ini.py.
"""

from __future__ import annotations

from typing import Dict


def parse_ini(path: str) -> Dict[str, Dict[str, str]]:
    sections: Dict[str, Dict[str, str]] = {}
    current = "global"
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(("//", "%", "#", ";")):
                continue
            if line.startswith("["):
                # tolerate a trailing inline comment after the bracket
                # ('[unary] // thresholds') like MRPT's CConfigFile does
                close = line.find("]")
                if close != -1:
                    current = line[1:close].strip().lower()
                    sections.setdefault(current, {})
                    continue
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            # strip trailing inline comments
            for marker in ("//", "%", "#", ";"):
                idx = value.find(marker)
                if idx != -1:
                    value = value[:idx]
            sections.setdefault(current, {})[key.strip().lower()] = value.strip()
    return sections
