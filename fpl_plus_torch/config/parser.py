"""INI experiment-config parser.

Byte-compatible with the reference config format (reference:
PyMIC/pymic/util/parse_config.py:7-117): a ``.cfg`` file with sections
``dataset/network/training/testing/evaluation`` whose string values are
auto-typed into int / float / bool / list / None, everything else staying a
string. Keys are lower-cased by configparser, so all lookups in the framework
use lower-case keys (``Pad_output_size`` is stored as ``pad_output_size``).
"""
from __future__ import annotations

import configparser
import logging
from typing import Any, Dict


def is_int(val_str: str) -> bool:
    if len(val_str) == 0:
        return False
    start = 1 if val_str[0] == '-' else 0
    if start == len(val_str):
        return False
    return val_str[start:].isdigit()


def is_float(val_str: str) -> bool:
    # Mirrors the reference's deliberately narrow notion of a float literal:
    # "a.b" with integer halves, or "aeb" scientific form ("1e-4" counts since
    # "-4" parses as int). Paths like "./x" are excluded by the "./" guard.
    if '.' in val_str and len(val_str.split('.')) == 2 and './' not in val_str:
        left, right = val_str.split('.')
        return is_int(left) and is_int(right)
    if 'e' in val_str and val_str[0] != 'e' and len(val_str.split('e')) == 2:
        left, right = val_str.split('e')
        return is_int(left) and is_int(right)
    return False


def is_bool(val_str: str) -> bool:
    return val_str.lower() in ('true', 'false')


def parse_bool(val_str: str) -> bool:
    return val_str.lower() == 'true'


def is_list(val_str: str) -> bool:
    return len(val_str) >= 2 and val_str[0] == '[' and val_str[-1] == ']'


def parse_list(val_str: str):
    items = val_str[1:-1].split(',')
    out = []
    for item in items:
        item = item.strip()
        if is_int(item):
            out.append(int(item))
        elif is_float(item):
            out.append(float(item))
        elif is_bool(item):
            out.append(parse_bool(item))
        elif item.lower() == 'none':
            out.append(None)
        else:
            out.append(item)
    return out


def parse_value_from_string(val_str: str):
    if is_int(val_str):
        return int(val_str)
    if is_float(val_str):
        return float(val_str)
    if is_list(val_str):
        return parse_list(val_str)
    if is_bool(val_str):
        return parse_bool(val_str)
    if val_str.lower() == 'none':
        return None
    return val_str


def parse_config(filename: str) -> Dict[str, Dict[str, Any]]:
    """Parse an INI experiment config into a two-level typed dict."""
    config = configparser.ConfigParser()
    read = config.read(filename)
    if not read:
        raise FileNotFoundError("config file not found: {0}".format(filename))
    output: Dict[str, Dict[str, Any]] = {}
    for section in config.sections():
        output[section] = {}
        for key in config[section]:
            val_str = str(config[section][key])
            if len(val_str) > 0:
                output[section][key] = parse_value_from_string(val_str)
            # empty value: key omitted (reference leaves it undefined too)
    return output


def synchronize_config(config: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Propagate class_num from [network] into label-transform params.

    Mirrors reference synchronize_config (parse_config.py:102-111).
    """
    data_cfg = config['dataset']
    net_cfg = config['network']
    data_cfg['labeltoprobability_class_num'] = net_cfg['class_num']
    train_transform = data_cfg.get('train_transform', None) or []
    if 'PartialLabelToProbability' in train_transform:
        data_cfg['partiallabeltoprobability_class_num'] = net_cfg['class_num']
    config['dataset'] = data_cfg
    config['network'] = net_cfg
    return config


def logging_config(config: Dict[str, Dict[str, Any]]) -> None:
    for section in config:
        for key in config[section]:
            logging.info("%s %s = %s", section, key, config[section][key])
