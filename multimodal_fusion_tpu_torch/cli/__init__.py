"""Command-line entry points of the port."""

import sys


def console_script(module_name: str):
    """The console-script entry (``script_main``) of the CLI module
    ``module_name``: it runs that module's ``main``, looked up at each call,
    and returns 0 for the wrapper to exit with, while ``main`` returns a
    result for programmatic callers."""

    def script_main(argv=None):
        sys.modules[module_name].main(argv)
        return 0

    return script_main
