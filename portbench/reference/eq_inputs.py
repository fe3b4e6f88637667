"""The equilibrium flagship's inputs, frozen: the files reference/inputs.py
writes for the configuration (atmosphere, tables, the free-chemistry cfg)
and, beside them, the cfg the program runs, with thermochemical
equilibrium in place of the free H2O VMR.

The rewrite is pyratbay_tpu_torch/benchmark.py equilibrium_flagship_cfg's,
copied: the lines `vmr_vars` and `bulk` go; after `radmodel` come
`chemistry = equilibrium`, the configuration's species, its solar
abundances and `vmr_vars` [M/H] and C/O at their values; the retrieval
rows are the configuration's own ([M/H] and C/O in log_H2O's place).
Plain text; imports nothing of the program.
"""
import os

from . import inputs


def cfg_text(free_text, config):
    """The equilibrium cfg from the free-chemistry cfg text of
    inputs.cfg_text."""
    chem = config['chemistry']
    lines = []
    for line in free_text.splitlines():
        if line.startswith(('vmr_vars', 'bulk')):
            continue
        lines.append(line)
        if line.startswith('radmodel'):
            lines += ['chemistry = equilibrium',
                      'species = ' + ' '.join(config['species']),
                      f"solar = {chem['solar']}",
                      'vmr_vars =',
                      f"    [M/H] {chem['metallicity']!r}",
                      f"    C/O {chem['c_to_o']!r}"]
    return '\n'.join(lines) + '\n'


def write_inputs(config, workdir):
    """inputs.write_inputs's files for the configuration (its free cfg's
    H2O line, which this rewrite drops, given no value) and the
    equilibrium cfg beside them (rewritten when it differs); returns the
    paths, 'cfg' the equilibrium one."""
    paths = inputs.write_inputs(dict(config, log_H2O=None), workdir)
    with open(paths['cfg']) as f:
        text = cfg_text(f.read(), config)
    eq_cfg = os.path.join(workdir, 'flagship_eq.cfg')
    old = None
    if os.path.isfile(eq_cfg):
        with open(eq_cfg) as f:
            old = f.read()
    if old != text:
        with open(eq_cfg, 'w') as f:
            f.write(text)
    return dict(paths, cfg=eq_cfg, free_cfg=paths['cfg'])
