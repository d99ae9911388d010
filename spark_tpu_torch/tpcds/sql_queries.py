"""TPC-DS tranche-1 queries as SQL text (the port's copy of
`spark_tpu/tpcds/sql_queries.py`: the same texts).

Adapted from the official templates to the store channel subset this
harness generates and to the syntax the frontend supports, the same
discipline as `tpch/sql_queries.py` ("the official query forms,
restricted to the syntax the frontend supports"). Documented
adaptations, applied consistently to SQL, DataFrame and golden forms:

- window-over-aggregate queries (q63/q89/q98) nest the aggregate in a
  FROM-subquery and apply the window above it (the frontend does not
  combine GROUP BY and OVER in one SELECT);
- equi-join conjuncts that the official text repeats inside OR branches
  (q48) are hoisted out of the OR, leaving only attribute bands inside
  — same relational semantics, no cross-join blowup;
- q1's correlated average is expressed as its standard decorrelated
  form (a second CTE grouping the first — still two references to the
  shared CTE);
- q59's per-week calendar join uses date_dim's Sunday rows (d_dow = 0,
  one row per week) instead of all seven days, so week rows are not
  duplicated;
- q19's shops-away-from-home predicate compares time zones
  (ca_gmt_offset <> s_gmt_offset) instead of 5-digit zip prefixes: the
  columnar string tier only compares strings against literals or a
  shared dictionary, and the numeric form keeps the same intent;
- q63/q89's monthly-deviation ratio divides by
  cast(avg_monthly_sales as double): the engine's decimal division
  NULLs rows past its f64-exactness bound at divisor scale 6 (the
  documented scaled-int64 deviation), and the double form matches what
  the reference computes for the ratio anyway;
- ORDER BY lists carry enough trailing keys to make every ordering
  total (golden parity cannot tolerate tie-dependent row order).
"""

Q1 = """
with customer_total_return as (
    select
        sr_customer_sk as ctr_customer_sk,
        sr_store_sk as ctr_store_sk,
        sum(sr_return_amt) as ctr_total_return
    from
        store_returns,
        date_dim
    where
        sr_returned_date_sk = d_date_sk
        and d_year = 2000
    group by
        sr_customer_sk,
        sr_store_sk
),
store_avg_return as (
    select
        ctr_store_sk as avg_store_sk,
        avg(ctr_total_return) * 1.2 as avg_return
    from
        customer_total_return
    group by
        ctr_store_sk
)
select
    c_customer_id
from
    customer_total_return,
    store_avg_return,
    store,
    customer
where
    ctr_store_sk = avg_store_sk
    and ctr_total_return > avg_return
    and s_store_sk = ctr_store_sk
    and s_state = 'TN'
    and ctr_customer_sk = c_customer_sk
order by
    c_customer_id
limit 100
"""

Q3 = """
select
    d_year,
    i_brand_id as brand_id,
    i_brand as brand,
    sum(ss_ext_sales_price) as sum_agg
from
    date_dim,
    store_sales,
    item
where
    d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manufact_id = 28
    and d_moy = 11
group by
    d_year,
    i_brand_id,
    i_brand
order by
    d_year,
    sum_agg desc,
    brand_id
limit 100
"""

Q7 = """
select
    i_item_id,
    avg(ss_quantity) as agg1,
    avg(ss_list_price) as agg2,
    avg(ss_coupon_amt) as agg3,
    avg(ss_sales_price) as agg4
from
    store_sales,
    customer_demographics,
    date_dim,
    item,
    promotion
where
    ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
    and ss_cdemo_sk = cd_demo_sk
    and ss_promo_sk = p_promo_sk
    and cd_gender = 'M'
    and cd_marital_status = 'S'
    and cd_education_status = 'College'
    and (p_channel_email = 'N' or p_channel_event = 'N')
    and d_year = 2000
group by
    i_item_id
order by
    i_item_id
limit 100
"""

Q19 = """
select
    i_brand_id as brand_id,
    i_brand as brand,
    i_manufact_id,
    i_manufact,
    sum(ss_ext_sales_price) as ext_price
from
    date_dim,
    store_sales,
    item,
    customer,
    customer_address,
    store
where
    d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manager_id = 8
    and d_moy = 11
    and d_year = 1998
    and ss_customer_sk = c_customer_sk
    and c_current_addr_sk = ca_address_sk
    and ca_gmt_offset <> s_gmt_offset
    and ss_store_sk = s_store_sk
group by
    i_brand_id,
    i_brand,
    i_manufact_id,
    i_manufact
order by
    ext_price desc,
    brand_id,
    i_manufact_id
limit 100
"""

Q27 = """
select
    i_item_id,
    s_state,
    avg(ss_quantity) as agg1,
    avg(ss_list_price) as agg2,
    avg(ss_coupon_amt) as agg3,
    avg(ss_sales_price) as agg4
from
    store_sales,
    customer_demographics,
    date_dim,
    store,
    item
where
    ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk
    and ss_cdemo_sk = cd_demo_sk
    and cd_gender = 'F'
    and cd_marital_status = 'W'
    and cd_education_status = 'Primary'
    and d_year = 2002
    and s_state in ('TN', 'OH')
group by
    rollup(i_item_id, s_state)
order by
    i_item_id,
    s_state
limit 100
"""

Q42 = """
select
    d_year,
    i_category_id,
    i_category,
    sum(ss_ext_sales_price) as total_sales
from
    date_dim,
    store_sales,
    item
where
    d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manager_id = 1
    and d_moy = 11
    and d_year = 2000
group by
    d_year,
    i_category_id,
    i_category
order by
    total_sales desc,
    d_year,
    i_category_id
limit 100
"""

Q43 = """
select
    s_store_name,
    s_store_id,
    sum(case when d_day_name = 'Sunday' then ss_sales_price
        else null end) as sun_sales,
    sum(case when d_day_name = 'Monday' then ss_sales_price
        else null end) as mon_sales,
    sum(case when d_day_name = 'Tuesday' then ss_sales_price
        else null end) as tue_sales,
    sum(case when d_day_name = 'Wednesday' then ss_sales_price
        else null end) as wed_sales,
    sum(case when d_day_name = 'Thursday' then ss_sales_price
        else null end) as thu_sales,
    sum(case when d_day_name = 'Friday' then ss_sales_price
        else null end) as fri_sales,
    sum(case when d_day_name = 'Saturday' then ss_sales_price
        else null end) as sat_sales
from
    date_dim,
    store_sales,
    store
where
    d_date_sk = ss_sold_date_sk
    and ss_store_sk = s_store_sk
    and s_gmt_offset = -5.00
    and d_year = 2000
group by
    s_store_name,
    s_store_id
order by
    s_store_name,
    s_store_id
limit 100
"""

Q48 = """
select
    sum(ss_quantity) as quantity_sum
from
    store_sales,
    store,
    customer_demographics,
    customer_address,
    date_dim
where
    s_store_sk = ss_store_sk
    and ss_sold_date_sk = d_date_sk
    and ss_cdemo_sk = cd_demo_sk
    and ss_addr_sk = ca_address_sk
    and d_year = 2001
    and (
        (cd_marital_status = 'M'
         and cd_education_status = '4 yr Degree'
         and ss_sales_price between 100.00 and 150.00)
        or (cd_marital_status = 'D'
            and cd_education_status = '2 yr Degree'
            and ss_sales_price between 50.00 and 100.00)
        or (cd_marital_status = 'S'
            and cd_education_status = 'College'
            and ss_sales_price between 150.00 and 200.00)
    )
    and (
        (ca_country = 'United States'
         and ca_state in ('CO', 'OH', 'TX')
         and ss_net_profit between 0 and 2000)
        or (ca_country = 'United States'
            and ca_state in ('OR', 'MN', 'KY')
            and ss_net_profit between 150 and 3000)
        or (ca_country = 'United States'
            and ca_state in ('VA', 'CA', 'MS')
            and ss_net_profit between 50 and 25000)
    )
"""

Q52 = """
select
    d_year,
    i_brand_id as brand_id,
    i_brand as brand,
    sum(ss_ext_sales_price) as ext_price
from
    date_dim,
    store_sales,
    item
where
    d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manager_id = 1
    and d_moy = 11
    and d_year = 2000
group by
    d_year,
    i_brand_id,
    i_brand
order by
    d_year,
    ext_price desc,
    brand_id
limit 100
"""

Q55 = """
select
    i_brand_id as brand_id,
    i_brand as brand,
    sum(ss_ext_sales_price) as ext_price
from
    date_dim,
    store_sales,
    item
where
    d_date_sk = ss_sold_date_sk
    and ss_item_sk = i_item_sk
    and i_manager_id = 28
    and d_moy = 11
    and d_year = 1999
group by
    i_brand_id,
    i_brand
order by
    ext_price desc,
    brand_id
limit 100
"""

Q59 = """
with wss as (
    select
        d_week_seq,
        ss_store_sk,
        sum(case when d_day_name = 'Sunday' then ss_sales_price
            else null end) as sun_sales,
        sum(case when d_day_name = 'Monday' then ss_sales_price
            else null end) as mon_sales,
        sum(case when d_day_name = 'Tuesday' then ss_sales_price
            else null end) as tue_sales,
        sum(case when d_day_name = 'Wednesday' then ss_sales_price
            else null end) as wed_sales,
        sum(case when d_day_name = 'Thursday' then ss_sales_price
            else null end) as thu_sales,
        sum(case when d_day_name = 'Friday' then ss_sales_price
            else null end) as fri_sales,
        sum(case when d_day_name = 'Saturday' then ss_sales_price
            else null end) as sat_sales
    from
        store_sales,
        date_dim
    where
        d_date_sk = ss_sold_date_sk
    group by
        d_week_seq,
        ss_store_sk
)
select
    s_store_name1,
    s_store_id1,
    d_week_seq1,
    sun_sales1 / sun_sales2 as r_sun,
    mon_sales1 / mon_sales2 as r_mon,
    tue_sales1 / tue_sales2 as r_tue,
    wed_sales1 / wed_sales2 as r_wed,
    thu_sales1 / thu_sales2 as r_thu,
    fri_sales1 / fri_sales2 as r_fri,
    sat_sales1 / sat_sales2 as r_sat
from
    (select
         s_store_name as s_store_name1,
         wss.d_week_seq as d_week_seq1,
         s_store_id as s_store_id1,
         sun_sales as sun_sales1,
         mon_sales as mon_sales1,
         tue_sales as tue_sales1,
         wed_sales as wed_sales1,
         thu_sales as thu_sales1,
         fri_sales as fri_sales1,
         sat_sales as sat_sales1
     from
         wss,
         store,
         (select d_week_seq as w_week_seq, d_month_seq as w_month_seq
          from date_dim where d_dow = 0) w1
     where
         w_week_seq = wss.d_week_seq
         and ss_store_sk = s_store_sk
         and w_month_seq between 24 and 35) y,
    (select
         s_store_name as s_store_name2,
         wss.d_week_seq as d_week_seq2,
         s_store_id as s_store_id2,
         sun_sales as sun_sales2,
         mon_sales as mon_sales2,
         tue_sales as tue_sales2,
         wed_sales as wed_sales2,
         thu_sales as thu_sales2,
         fri_sales as fri_sales2,
         sat_sales as sat_sales2
     from
         wss,
         store,
         (select d_week_seq as w_week_seq, d_month_seq as w_month_seq
          from date_dim where d_dow = 0) w2
     where
         w_week_seq = wss.d_week_seq
         and ss_store_sk = s_store_sk
         and w_month_seq between 36 and 47) x
where
    s_store_id1 = s_store_id2
    and d_week_seq1 = d_week_seq2 - 52
order by
    s_store_name1,
    s_store_id1,
    d_week_seq1
limit 100
"""

Q61 = """
select
    promotions,
    total,
    promotions / total * 100 as ratio
from
    (select sum(ss_ext_sales_price) as promotions
     from
         store_sales,
         store,
         promotion,
         date_dim,
         customer,
         customer_address,
         item
     where
         ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and ss_promo_sk = p_promo_sk
         and ss_customer_sk = c_customer_sk
         and ca_address_sk = c_current_addr_sk
         and ss_item_sk = i_item_sk
         and ca_gmt_offset = -5
         and i_category = 'Jewelry'
         and (p_channel_dmail = 'Y' or p_channel_tv = 'Y'
              or p_channel_event = 'Y')
         and s_gmt_offset = -5
         and d_year = 1998
         and d_moy = 11) promotional_sales,
    (select sum(ss_ext_sales_price) as total
     from
         store_sales,
         store,
         date_dim,
         customer,
         customer_address,
         item
     where
         ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and ss_customer_sk = c_customer_sk
         and ca_address_sk = c_current_addr_sk
         and ss_item_sk = i_item_sk
         and ca_gmt_offset = -5
         and i_category = 'Jewelry'
         and s_gmt_offset = -5
         and d_year = 1998
         and d_moy = 11) all_sales
"""

Q63 = """
select
    i_manager_id,
    d_moy,
    sum_sales,
    avg_monthly_sales
from
    (select
         i_manager_id,
         d_moy,
         sum_sales,
         avg(sum_sales) over (partition by i_manager_id)
             as avg_monthly_sales
     from
         (select
              i_manager_id,
              d_moy,
              sum(ss_sales_price) as sum_sales
          from
              item,
              store_sales,
              date_dim,
              store
          where
              ss_item_sk = i_item_sk
              and ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk
              and d_year = 2000
              and ((i_category in ('Books', 'Children', 'Electronics')
                    and i_class in ('Books class 1', 'Children class 2',
                                    'Electronics class 3'))
                   or (i_category in ('Women', 'Music', 'Men')
                       and i_class in ('Women class 1', 'Music class 2',
                                       'Men class 3')))
          group by
              i_manager_id,
              d_moy) tmp1) tmp2
where
    avg_monthly_sales > 0
    and abs(sum_sales - avg_monthly_sales)
        / cast(avg_monthly_sales as double) > 0.1
order by
    i_manager_id,
    avg_monthly_sales,
    sum_sales,
    d_moy
limit 100
"""

Q65 = """
with sc as (
    select
        ss_store_sk,
        ss_item_sk,
        sum(ss_sales_price) as revenue
    from
        store_sales,
        date_dim
    where
        ss_sold_date_sk = d_date_sk
        and d_month_seq between 24 and 35
    group by
        ss_store_sk,
        ss_item_sk
),
sb as (
    select
        ss_store_sk as store_sk,
        avg(revenue) as ave
    from
        sc
    group by
        ss_store_sk
)
select
    s_store_name,
    i_item_desc,
    revenue,
    i_current_price,
    i_wholesale_cost,
    i_brand
from
    store,
    item,
    sb,
    sc
where
    store_sk = sc.ss_store_sk
    and revenue <= 0.1 * ave
    and s_store_sk = sc.ss_store_sk
    and i_item_sk = sc.ss_item_sk
order by
    s_store_name,
    i_item_desc,
    i_brand,
    revenue,
    i_current_price
limit 100
"""

Q68 = """
select
    c_last_name,
    c_first_name,
    ca_city,
    bought_city,
    ss_ticket_number,
    extended_price,
    extended_tax,
    list_price
from
    (select
         ss_ticket_number,
         ss_customer_sk,
         ca_city as bought_city,
         sum(ss_ext_sales_price) as extended_price,
         sum(ss_ext_list_price) as list_price,
         sum(ss_ext_tax) as extended_tax
     from
         store_sales,
         date_dim,
         store,
         household_demographics,
         customer_address
     where
         ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and ss_hdemo_sk = hd_demo_sk
         and ss_addr_sk = ca_address_sk
         and d_dom between 1 and 2
         and (hd_dep_count = 4 or hd_vehicle_count = 3)
         and d_year in (1999, 2000, 2001)
         and s_city in ('Midway', 'Fairview')
     group by
         ss_ticket_number,
         ss_customer_sk,
         ss_addr_sk,
         ca_city) dn,
    customer,
    customer_address current_addr
where
    ss_customer_sk = c_customer_sk
    and customer.c_current_addr_sk = current_addr.ca_address_sk
    and current_addr.ca_city <> bought_city
order by
    c_last_name,
    ss_ticket_number
limit 100
"""

Q73 = """
select
    c_last_name,
    c_first_name,
    c_salutation,
    c_preferred_cust_flag,
    ss_ticket_number,
    cnt
from
    (select
         ss_ticket_number,
         ss_customer_sk,
         count(*) as cnt
     from
         store_sales,
         date_dim,
         store,
         household_demographics
     where
         ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and ss_hdemo_sk = hd_demo_sk
         and d_dom between 1 and 2
         and (hd_buy_potential = '>10000'
              or hd_buy_potential = 'Unknown')
         and hd_vehicle_count > 0
         and d_year in (1999, 2000, 2001)
         and s_county in ('Williamson County', 'Franklin Parish')
     group by
         ss_ticket_number,
         ss_customer_sk) dj,
    customer
where
    ss_customer_sk = c_customer_sk
    and cnt between 1 and 5
order by
    cnt desc,
    c_last_name asc,
    ss_ticket_number
limit 100
"""

Q79 = """
select
    c_last_name,
    c_first_name,
    substring(s_city, 1, 30) as city,
    ss_ticket_number,
    amt,
    profit
from
    (select
         ss_ticket_number,
         ss_customer_sk,
         s_city,
         sum(ss_coupon_amt) as amt,
         sum(ss_net_profit) as profit
     from
         store_sales,
         date_dim,
         store,
         household_demographics
     where
         ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and ss_hdemo_sk = hd_demo_sk
         and (hd_dep_count = 6 or hd_vehicle_count > 2)
         and d_dow = 1
         and d_year in (1998, 1999, 2000)
         and s_number_employees between 200 and 295
     group by
         ss_ticket_number,
         ss_customer_sk,
         ss_addr_sk,
         s_city) ms,
    customer
where
    ss_customer_sk = c_customer_sk
order by
    c_last_name,
    c_first_name,
    city,
    profit,
    ss_ticket_number
limit 100
"""

Q89 = """
select
    i_category,
    i_class,
    i_brand,
    s_store_name,
    s_company_name,
    d_moy,
    sum_sales,
    avg_monthly_sales
from
    (select
         i_category,
         i_class,
         i_brand,
         s_store_name,
         s_company_name,
         d_moy,
         sum_sales,
         avg(sum_sales) over (partition by i_category, i_brand,
                              s_store_name, s_company_name)
             as avg_monthly_sales
     from
         (select
              i_category,
              i_class,
              i_brand,
              s_store_name,
              s_company_name,
              d_moy,
              sum(ss_sales_price) as sum_sales
          from
              item,
              store_sales,
              date_dim,
              store
          where
              ss_item_sk = i_item_sk
              and ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk
              and d_year = 1999
              and ((i_category in ('Books', 'Electronics', 'Sports')
                    and i_class in ('Books class 1',
                                    'Electronics class 2',
                                    'Sports class 3'))
                   or (i_category in ('Men', 'Jewelry', 'Women')
                       and i_class in ('Men class 4', 'Jewelry class 1',
                                       'Women class 2')))
          group by
              i_category,
              i_class,
              i_brand,
              s_store_name,
              s_company_name,
              d_moy) t1) t2
where
    avg_monthly_sales <> 0
    and (sum_sales - avg_monthly_sales)
        / cast(avg_monthly_sales as double) < -0.1
order by
    sum_sales - avg_monthly_sales,
    s_store_name,
    i_category,
    i_class,
    i_brand,
    d_moy
limit 100
"""

Q93 = """
select
    ss_customer_sk,
    sum(act_sales) as sumsales
from
    (select
         ss_customer_sk,
         (ss_quantity - sr_return_quantity) * ss_sales_price as act_sales
     from
         store_sales,
         store_returns,
         reason
     where
         sr_item_sk = ss_item_sk
         and sr_ticket_number = ss_ticket_number
         and sr_reason_sk = r_reason_sk
         and r_reason_desc = 'reason 19') t
group by
    ss_customer_sk
order by
    sumsales,
    ss_customer_sk
limit 100
"""

Q96 = """
select
    count(*) as cnt
from
    store_sales,
    household_demographics,
    time_dim,
    store
where
    ss_sold_time_sk = t_time_sk
    and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk
    and t_hour = 20
    and t_minute >= 30
    and hd_dep_count = 7
    and s_store_name = 'ese'
"""

Q98 = """
select
    i_item_id,
    i_item_desc,
    i_category,
    i_class,
    i_current_price,
    itemrevenue,
    revenueratio
from
    (select
         i_item_id,
         i_item_desc,
         i_category,
         i_class,
         i_current_price,
         itemrevenue,
         itemrevenue * 100.0000 / sum(itemrevenue)
             over (partition by i_class) as revenueratio
     from
         (select
              i_item_id,
              i_item_desc,
              i_category,
              i_class,
              i_current_price,
              sum(ss_ext_sales_price) as itemrevenue
          from
              store_sales,
              item,
              date_dim
          where
              ss_item_sk = i_item_sk
              and i_category in ('Sports', 'Books', 'Home')
              and ss_sold_date_sk = d_date_sk
              and d_date between date '1999-02-22' and date '1999-03-24'
          group by
              i_item_id,
              i_item_desc,
              i_category,
              i_class,
              i_current_price) t1) t2
order by
    i_category,
    i_class,
    i_item_id,
    i_item_desc,
    revenueratio
"""

SQL_QUERIES = {
    "q1": Q1, "q3": Q3, "q7": Q7, "q19": Q19, "q27": Q27, "q42": Q42,
    "q43": Q43, "q48": Q48, "q52": Q52, "q55": Q55, "q59": Q59,
    "q61": Q61, "q63": Q63, "q65": Q65, "q68": Q68, "q73": Q73,
    "q79": Q79, "q89": Q89, "q93": Q93, "q96": Q96, "q98": Q98,
}
