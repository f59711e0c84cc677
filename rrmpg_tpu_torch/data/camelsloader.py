"""CAMELS data loader (pandas only).

Counterpart of ``rrmpg_tpu.data.CAMELSLoader`` (reference
``rrmpg/data/camelsloader.py:14-129``): Daymet forcing and model-output
files per basin, PET and observed discharge joined, a datetime index,
trimmed to complete hydrological years (Oct 1 - Sep 30).  ``-999``
discharge sentinels come back as NaN.

By default it reads the files bundled with the JAX package, in place at
``rrmpg_tpu/data/camels/``, by path: importing ``rrmpg_tpu`` would import
JAX.

CAMELS: Addor, Newman, Mizukami & Clark (2017), doi:10.5065/D6G73C3Q.
"""

from pathlib import Path

import pandas as pd

BUNDLED_DIR = (Path(__file__).resolve().parents[2] / "rrmpg_tpu" / "data"
               / "camels")


class CAMELSLoader(object):
    """Interface for loading basins of the CAMELS dataset.

    Args:
        data_dir: (optional) directory of CAMELS-format files
            (``<basin>_lump_cida_forcing_leap.txt`` plus
            ``<basin>_05_model_output.txt`` per basin).  Defaults to the
            bundled toy data (one basin, 01031500).
    """

    VALID_BASINS = ['01031500']

    def __init__(self, data_dir=None):
        self._dir = BUNDLED_DIR if data_dir is None else Path(data_dir)
        if data_dir is not None:
            if not self._dir.is_dir():
                raise ValueError(
                    f"CAMELS directory {data_dir!r} does not exist.")
            suffix = '_lump_cida_forcing_leap.txt'
            basins = sorted(
                f.name[:-len(suffix)] for f in self._dir.glob(f'*{suffix}')
                if (self._dir /
                    f"{f.name[:-len(suffix)]}_05_model_output.txt").exists())
            if not basins:
                raise ValueError(
                    f"No CAMELS basin file pairs found in {data_dir!r} "
                    "(expected <basin>_lump_cida_forcing_leap.txt + "
                    "<basin>_05_model_output.txt).")
            self.VALID_BASINS = basins

    def _check_basin(self, basin_number):
        if basin_number not in self.VALID_BASINS:
            raise ValueError(
                f"No data for basin {basin_number!r}; available "
                f"basins: {self.VALID_BASINS}.")

    def load_basin(self, basin_number):
        """Load one basin as a pandas DataFrame.

        Returns:
            DataFrame with daily forcing columns, 'PET' and 'QObs(mm/d)'
            (NaN where the file holds a negative sentinel), indexed by
            date and trimmed to complete hydrological years.

        Raises:
            ValueError: If the basin number is invalid.
        """
        self._check_basin(basin_number)
        met_file = self._dir / f"{basin_number}_lump_cida_forcing_leap.txt"
        streamflow_file = self._dir / f"{basin_number}_05_model_output.txt"

        df = pd.read_csv(met_file, sep=r'\s+', header=3)
        df.index = pd.to_datetime(
            df[['Year', 'Mnth', 'Day']].set_axis(
                ['year', 'month', 'day'], axis=1))

        df2 = pd.read_csv(streamflow_file, sep=r'\s+', header=0)
        df2.index = pd.to_datetime(
            df2[['YR', 'MNTH', 'DY']].set_axis(
                ['year', 'month', 'day'], axis=1))

        df['PET'] = df2['PET']
        df['QObs(mm/d)'] = df2['OBS_RUN'].mask(df2['OBS_RUN'] < 0)
        df = df.drop(['Year', 'Mnth', 'Day', 'Hr'], axis=1)

        # Trim to complete hydrological years (Oct 1 - Sep 30).
        start_date = pd.to_datetime(f"{df.index[0].year}/10/01",
                                    format="%Y/%m/%d")
        end_date = pd.to_datetime(f"{df.index[-1].year}/09/30",
                                  format="%Y/%m/%d")
        return df[start_date:end_date]

    def get_basin_numbers(self):
        """Return the available basin ids."""
        return self.VALID_BASINS

    def get_station_height(self, basin_number):
        """Return the elevation of the meteorological station of one basin.

        Raises:
            ValueError: If the basin number is invalid.
        """
        self._check_basin(basin_number)
        met_file = self._dir / f"{basin_number}_lump_cida_forcing_leap.txt"
        with open(met_file, 'r') as fp:
            fp.readline()
            return float(fp.readline().strip())
