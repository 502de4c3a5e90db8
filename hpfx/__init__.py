"""hpfx — harmonic power flow in JAX.

A from-scratch re-design of the capabilities of
``pweigmann/harmonic-power-flow`` (harmonically-coupled Norton-equivalent
power flow) as a JAX/XLA library: dense per-harmonic split-complex
tensors, ``lax.while_loop`` Newton-Raphson, ``vmap`` or lane-major
scenario batching with batched linear solves, and ``jax.sharding``
scenario-axis parallelism over device meshes.
"""
from . import cx
from .checkpoint import load_result, save_result, warm_start
from .config import Settings, default_harmonics, settings_for_hmax
from .cx import Cx
from .devices import (AnalyticDeviceSet, DeviceLibrary, DeviceSet,
                      device_set_from_arrays, fit_coupled_ne,
                      fit_uncoupled_ne, load_device_library, load_device_set,
                      load_norton_equivalent, ne_injection, ne_selftest,
                      norton_inject)
from .fundamental import FundResult, pf, solve_fundamental
from .harmonic import HPFResult, hpf, solve_harmonic
from .ne_pipeline import (MeasurementSet, NortonFit, device_set_from_fit,
                          export_ne_csv, export_opendss_spectrum,
                          fit_norton_from_measurements, load_measurements_mat)
from .lineskin import line_resistance, skin_ratio, skin_structures
from .activefilter import ActiveFilterSizing, size_active_filter
from .opendss import device_spectra_at_nominal, export_opendss_case
from .converters import (NotchReport, converter_device_set,
                         converter_warm_start, notch_analysis,
                         six_pulse_spectrum,
                         synth_waveform, table_spectrum,
                         twelve_pulse_spectrum)
from .longline import (electrical_length, longline_factors,
                       longline_structures)
from .warmstart import harmonic_linear_seed, norton_warm_start
from .matpower import load_matpower, parse_matpower
from .loadmodel import damped_structures, linear_load_admittance
from .network import Network, load_network, network_from_arrays
from .results import (THD, HPFReport, WaveformMetrics, get_thd, report,
                      voltage_phasors, waveform, waveform_metrics)
from .solve import (Scenarios, SweepSummary, hosting_capacity_sweep,
                    hpf_single, hpf_sweep, hpf_sweep_adaptive,
                    hpf_sweep_continuation, hpf_sweep_device,
                    hpf_sweep_stream, summarize_thd)
from .arrow import arrow_solve, build_arrow_pieces, make_arrow_index
from .background import (background_from_harmonics, background_sweep,
                         current_source, grid_source, shunt_admittance)
from .capacity import (HostingCapacityResult, compliance_fraction,
                       find_hosting_capacity, monte_carlo_scenarios,
                       scale_scenarios)
from .contingency import (ContingencyReport, ContingencySweepReport,
                          ResonanceShiftReport, device_outage_scenarios,
                          islanded_lines, outage_impedance_shift,
                          screen_device_outages, screen_line_outages,
                          screen_line_outages_sweep,
                          screen_shunt_outages)
from .estimate import (BackgroundEstimate, EstimateResult,
                       estimate_background, estimate_injections)
from .extended import (ControlledDeviceSet, ExtendedResult, hpf_extended,
                       solve_harmonic_extended)
from .generators import synthetic_feeder
from .kron import KronReduction, kron_reduce, passive_buses, recover_voltages
from .network import validate_network
from .flows import (IEEE519CurrentReport, IEEE519Report, IEEE519Summary,
                    LineFlows, PowerIndices, check_en50160, check_ieee519,
                    check_ieee519_current, en50160_screen, ieee519_screen,
                    k_factor, line_flows, line_power_indices, power_indices)
from .iec import (aggregate_contributions, apportion_planning_level,
                  summation_alpha, summation_law)
from .impedance import (ctype_filter_admittance, distortion_contributions,
                        driving_point_impedance, frequency_scan,
                        highpass_filter_admittance, impedance_scan,
                        install_shunt, install_shunts, resonance_peaks,
                        tuned_filter_admittance)
from .modes import (CriticalMode, ModalScan, critical_mode,
                    eigen_sensitivity, modal_peaks, modal_scan,
                    modal_spectrum)
from .optimize import (FilterOptResult, OptimizeResult, apply_line_params,
                       optimize_filter, optimize_line_params)
from .placement import (FilterPlan, PlacementReport, dominant_orders,
                        filter_ydiag, plan_filter_bank,
                        screen_filter_placement)
from .sequence import (SequenceSet, balanced_phases, classify_orders,
                       delta_blocked, delta_device_set, hpf_sequence,
                       neutral_current, phase_components,
                       sequence_components, sequence_structures,
                       triplen_mask, zero_sequence_network)
from .sensitivity import (FilterParams, LineParams, ScenarioParams,
                          Sensitivity, filter_sensitivity,
                          injection_sensitivity, line_sensitivity,
                          mix_sensitivity, scenario_sensitivity,
                          sweep_filter_sensitivity, sweep_sensitivity)
from .studies import (PercentileComplianceReport, PlanningLevelReport,
                      QuantileAssessment, assess_quantiles,
                      check_planning_levels, daily_profile,
                      metric_quantiles, percentile_compliance,
                      profile_scenarios, run_timeseries,
                      summarize_quantiles)
from .threephase import (AllocationStudy, PhaseFlows, ThreePhaseResult,
                         abc_admittance, allocation_study,
                         line_phase_flows, phase_injections,
                         sequence_voltages, solve_unbalanced,
                         unbalance_factors)
from .trajlog import (read_ilog, read_vlog, trajectory_injections,
                      write_ilog, write_vlog)
from .ybus import build_ybus, fold_ydiag

__version__ = "0.1.0"

__all__ = [
    "cx", "Cx",
    "Settings", "default_harmonics", "settings_for_hmax",
    "Network", "load_network", "network_from_arrays",
    "load_matpower", "parse_matpower",
    "build_ybus", "fold_ydiag", "linear_load_admittance",
    "damped_structures",
    "line_resistance", "skin_ratio", "skin_structures",
    "electrical_length", "longline_factors", "longline_structures",
    "ActiveFilterSizing", "size_active_filter",
    "export_opendss_case", "device_spectra_at_nominal",
    "converter_device_set", "converter_warm_start",
    "harmonic_linear_seed", "norton_warm_start",
    "NotchReport", "notch_analysis",
    "six_pulse_spectrum", "twelve_pulse_spectrum",
    "table_spectrum", "synth_waveform",
    "SequenceSet", "sequence_components", "phase_components",
    "balanced_phases", "classify_orders", "triplen_mask",
    "neutral_current", "delta_blocked",
    "hpf_sequence", "sequence_structures", "zero_sequence_network",
    "delta_device_set",
    "ThreePhaseResult", "abc_admittance", "phase_injections",
    "solve_unbalanced", "sequence_voltages", "unbalance_factors",
    "AllocationStudy", "allocation_study",
    "PhaseFlows", "line_phase_flows",
    "ContingencyReport", "ResonanceShiftReport", "islanded_lines",
    "outage_impedance_shift", "screen_line_outages",
    "screen_line_outages_sweep", "ContingencySweepReport",
    "screen_shunt_outages", "screen_device_outages",
    "device_outage_scenarios",
    "QuantileAssessment", "PlanningLevelReport",
    "PercentileComplianceReport", "assess_quantiles",
    "metric_quantiles",
    "summarize_quantiles", "check_planning_levels", "profile_scenarios",
    "run_timeseries", "percentile_compliance", "daily_profile",
    "DeviceSet", "AnalyticDeviceSet", "DeviceLibrary", "load_device_set",
    "load_device_library",
    "load_norton_equivalent", "device_set_from_arrays", "fit_coupled_ne",
    "fit_uncoupled_ne", "ne_injection", "ne_selftest", "norton_inject",
    "FundResult", "pf", "solve_fundamental",
    "HPFResult", "hpf", "solve_harmonic",
    "THD", "HPFReport", "get_thd", "report", "voltage_phasors",
    "WaveformMetrics", "waveform", "waveform_metrics",
    "Scenarios", "SweepSummary", "hpf_single", "hpf_sweep",
    "hpf_sweep_adaptive", "hpf_sweep_continuation",
    "hpf_sweep_device",
    "hpf_sweep_stream",
    "hosting_capacity_sweep", "summarize_thd",
    "MeasurementSet", "NortonFit", "load_measurements_mat",
    "fit_norton_from_measurements", "device_set_from_fit",
    "export_ne_csv", "export_opendss_spectrum",
    "save_result", "load_result", "warm_start",
    "synthetic_feeder", "validate_network",
    "write_vlog", "read_vlog", "write_ilog", "read_ilog",
    "trajectory_injections",
    "Sensitivity", "ScenarioParams", "LineParams", "FilterParams",
    "injection_sensitivity", "scenario_sensitivity", "mix_sensitivity",
    "line_sensitivity", "sweep_sensitivity", "filter_sensitivity",
    "sweep_filter_sensitivity",
    "impedance_scan", "driving_point_impedance", "resonance_peaks",
    "tuned_filter_admittance", "highpass_filter_admittance",
    "ctype_filter_admittance", "install_shunt", "install_shunts",
    "frequency_scan",
    "CriticalMode", "ModalScan", "critical_mode", "modal_scan",
    "modal_peaks", "eigen_sensitivity", "modal_spectrum",
    "LineFlows", "line_flows", "IEEE519Report", "check_ieee519",
    "PowerIndices", "power_indices", "line_power_indices",
    "IEEE519Summary", "ieee519_screen", "k_factor",
    "IEEE519CurrentReport", "check_ieee519_current",
    "check_en50160", "en50160_screen",
    "distortion_contributions",
    "summation_alpha", "summation_law", "aggregate_contributions",
    "apportion_planning_level",
    "OptimizeResult", "optimize_line_params", "apply_line_params",
    "FilterOptResult", "optimize_filter",
    "PlacementReport", "screen_filter_placement", "FilterPlan",
    "plan_filter_bank", "dominant_orders", "filter_ydiag",
    "EstimateResult", "estimate_injections",
    "BackgroundEstimate", "estimate_background",
    "background_from_harmonics", "background_sweep", "current_source",
    "grid_source",
    "shunt_admittance",
    "HostingCapacityResult", "find_hosting_capacity",
    "compliance_fraction", "monte_carlo_scenarios", "scale_scenarios",
    "arrow_solve", "build_arrow_pieces", "make_arrow_index",
    "KronReduction", "kron_reduce", "passive_buses", "recover_voltages",
    "ControlledDeviceSet", "ExtendedResult", "hpf_extended",
    "solve_harmonic_extended",
]
