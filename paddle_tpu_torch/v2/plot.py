"""``paddle.v2.plot`` (counterpart of ``paddle_tpu/v2/plot.py``): cost-curve
plotting during training.

Reference: ``python/paddle/v2/plot/plot.py`` (``Ploter``/``PlotData``,
matplotlib + IPython display, ``DISABLE_PLOT`` escape hatch), matplotlib
imported at first use.  It works headless: ``plot(path=...)`` saves a
PNG via the Agg backend; in a notebook it displays inline like the
reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class PlotData:
    def __init__(self):
        self.step: List[float] = []
        self.value: List[float] = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(float(value))

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *args: str):
        self.__args__ = args
        self.__plot_data__: Dict[str, PlotData] = {t: PlotData()
                                                   for t in args}

    def __plot_is_disabled__(self) -> bool:
        # read at call time — the reference's DISABLE_PLOT escape hatch
        # may be toggled after construction
        return os.environ.get("DISABLE_PLOT") == "True"

    def append(self, title: str, step, value) -> None:
        assert title in self.__plot_data__, title
        self.__plot_data__[title].append(step, value)

    def plot(self, path: Optional[str] = None) -> None:
        if self.__plot_is_disabled__():
            return
        import matplotlib
        if path is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        titles = []
        for title in self.__args__:
            data = self.__plot_data__[title]
            if len(data.step) > 0:
                plt.plot(data.step, data.value)
                titles.append(title)
        plt.legend(titles, loc="upper left")
        if path is None:  # notebook / interactive
            try:
                from IPython import display
                display.clear_output(wait=True)
                plt.pause(0.01)
            except ImportError:
                plt.show()
        else:
            plt.savefig(path)
            plt.close()

    def reset(self) -> None:
        for data in self.__plot_data__.values():
            data.reset()
